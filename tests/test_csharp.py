"""Gate for the C# engine-client component layer (examples/PlaneverbClient.cs).

The reference ships Unity C# components that demonstrably ran in its demo
game (/root/reference PlaneverbUnityPluginAPI/PlaneverbContext.cs:25-83);
our equivalent is a DllImport component layer over the C ABI
(planeverb/native/src/pv_engine_client.cpp). Two gates:

  - an ABI-consistency check that always runs: every [DllImport] entry point
    the C# declares must exist as an extern "C" export in the native client
    (and the core lifecycle exports must be declared on the C# side), so
    the two surfaces cannot drift apart silently;
  - a real compile of the .cs with mcs/csc when a C# compiler exists
    (skip-with-reason in images without one, like this container).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CS_PATH = os.path.join(_ROOT, "examples", "PlaneverbClient.cs")
C_PATH = os.path.join(_ROOT, "planeverb", "native", "src",
                      "pv_engine_client.cpp")


def _cs_imports() -> set[str]:
    src = open(CS_PATH).read()
    return set(re.findall(r"static\s+extern\s+\S+\s+(\w+)\s*\(", src))


def _c_exports() -> set[str]:
    src = open(C_PATH).read()
    # exported definitions: a Planeverb* identifier at the start of a
    # function signature (the file is extern "C" throughout its exports)
    return set(re.findall(r"\b(Planeverb\w+)\s*\(", src))


def test_csharp_dllimports_match_native_exports():
    imports = _cs_imports()
    exports = _c_exports()
    assert imports, "no DllImport declarations found in PlaneverbClient.cs"
    missing = imports - exports
    assert not missing, f"C# imports without native export: {sorted(missing)}"
    # the core lifecycle surface must be covered by the component layer
    for required in ("PlaneverbConnect", "PlaneverbDisconnect",
                     "PlaneverbInit", "PlaneverbExit", "PlaneverbEmit",
                     "PlaneverbEndEmission", "PlaneverbAddGeometry",
                     "PlaneverbRemoveGeometry",
                     "PlaneverbSetListenerPosition", "PlaneverbStep",
                     "PlaneverbGetOutput"):
        assert required in imports, required


def _compiler():
    for cand in ("mcs", "csc", "mono-csc", "dotnet-csc"):
        path = shutil.which(cand)
        if path:
            return path
    return None


@pytest.mark.skipif(_compiler() is None,
                    reason="no C# compiler (mcs/csc) in this image")
def test_csharp_component_compiles(tmp_path):
    out = tmp_path / "PlaneverbClient.dll"
    r = subprocess.run(
        [_compiler(), "-target:library", f"-out:{out}", CS_PATH],
        capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr or r.stdout
    assert out.exists()
