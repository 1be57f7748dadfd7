import os
import signal
import sys

import pytest

# NOTE: no xla_force_host_platform_device_count here — smoke tests and
# benches must see 1 device. Multi-device dry-run tests spawn subprocesses.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Per-test wall-clock timeout via SIGALRM (pytest-timeout is not available
# in this environment). A hung test — a stuck subprocess wait, a runtime
# loop that never converges — fails loudly with a traceback instead of
# stalling the whole suite until CI's job-level kill. Override with
# REPRO_TEST_TIMEOUT (seconds; 0 disables). Unix-only; a no-op elsewhere.
_TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "900"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if _TIMEOUT_S <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _timed_out(signum, frame):
        # Telemetry post-mortem: where was the run when it hung? The active
        # span stack names the phase (tick N, prefill chunk, swap-in...) and
        # the recent audit tail names the last arbiter decisions. Guarded —
        # a broken dump must not mask the timeout itself.
        try:
            from repro import obs
            obs.get_telemetry().debug_dump(file=sys.stderr, last=20)
        except Exception as e:  # pragma: no cover - diagnostics only
            print(f"[obs] telemetry dump failed: {e!r}", file=sys.stderr)
        raise TimeoutError(
            f"test exceeded REPRO_TEST_TIMEOUT={_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _timed_out)
    signal.alarm(_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (an H100 for the sm_90a kernels); "
                   "skips itself where torch.cuda.is_available() is False")
