"""Test-session set-up shared by every test directory of the repository."""

import fcntl


def pytest_sessionstart(session):
    """Build both packages' native feature loaders once, under a lock, as each test
    process starts and before it collects. On a fresh checkout the test workers would
    otherwise build them at the same moment (tests/test_native_io.py asks for the
    library while it is imported, at collection), and the JAX package's build writes one
    fixed temporary file: one worker's rename then fails, its loader stays off for that
    process, and every comparison against it fails or skips. A later process finds the
    libraries built."""
    from langsplat_tpu import native as jax_native
    from langsplat_tpu_torch import native as port_native

    port_native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(port_native.BUILD_DIR / "native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jax_native.get_library()
            try:
                port_native.build()
            except RuntimeError:
                pass    # no compiler: the port's loader tests raise it themselves
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
