"""Sandbox front-end: headless CLI, WAV I/O, and measurement sweeps
(PlaneverbSandbox + WetDryDoorPlot analogs; see cli.py)."""

from planeverb.sandbox.sweep import SweepResult, door_sweep
from planeverb.sandbox.wav import read_wav, write_wav

__all__ = ["SweepResult", "door_sweep", "read_wav", "write_wav"]
