"""Test harness config: an 8-device virtual CPU mesh so multi-device
sharding paths compile and execute without accelerators, and the native
PDF engine built from source before any test loads it."""
import os

# the suite runs on the CPU backend whatever the machine has; tests that
# need an accelerator carry the `gpu` marker and check for it themselves
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from synapta_tpu.utils.jaxsetup import setup_jax  # noqa: E402
setup_jax()

import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def pytest_configure(config):
    """Build the native engine once (`make -C native`): the controller
    process builds before xdist starts its workers, and a file lock keeps
    concurrent sessions from linking the same library at once."""
    if hasattr(config, "workerinput"):
        return
    import fcntl
    import subprocess

    (REPO / "native").mkdir(exist_ok=True)
    with open(REPO / "native" / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(
            ["make", "-C", str(REPO / "native"), f"-j{os.cpu_count() or 1}"],
            check=True, stdout=subprocess.DEVNULL,
        )


GOLDEN_DIR = Path("/root/reference/extracted_visuals_excelSS")


def _golden(name: str) -> Path:
    path = GOLDEN_DIR / name
    if not path.exists():
        pytest.skip(f"golden sample absent: {path}")
    return path


@pytest.fixture(scope="session")
def golden_segments_path():
    return _golden("textbook_001_visual_segments.json")


@pytest.fixture(scope="session")
def golden_csv_path():
    return _golden("textbook_001_visual_summary.csv")
