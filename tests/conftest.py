import os
import sys
from pathlib import Path

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (dry-run subprocess tests set it themselves).
SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: spawns real worker subprocesses (skippable with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA card (the port's CUDA kernels); skips without one")
