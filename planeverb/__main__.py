"""``python -m planeverb`` — sandbox CLI entry point."""

import sys

from planeverb.sandbox.cli import main
from planeverb.utils.compile_cache import enable_compile_cache

if __name__ == "__main__":
    enable_compile_cache()
    sys.exit(main())
