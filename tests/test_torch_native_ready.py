"""``jax_native_ready``: the port tests that hold the port's image
preprocessing against the JAX package's call it before they build a JAX
result.

``tvc.native`` builds ``_image_ops.so`` at first use by writing straight to
its final path, and a loader that finds the file missing or half written
remembers the failure for the rest of the process (``_TRIED = True``,
``_LIB = None``); ``tvc.models.clip.preprocess_images`` then resizes with
PIL. Test processes that start together race to build the file, and the
loser's JAX side would quietly resize otherwise than the port, which always
resizes natively. The helper forgets a failed load, retries until another
process's compiler has finished, and asserts that the library loaded, so a
comparison never runs against the PIL fallback unnoticed."""

import time

import pytest

#: how long to wait for another process's build of the library
WAIT_S = 30.0


def jax_native_ready(timeout: float = WAIT_S, pause: float = 0.25):
    """``tvc.native`` with its image library loaded (asserted)."""
    from tvc import native

    deadline = time.monotonic() + timeout
    while True:
        if native._LIB is None:
            # forget a failed attempt: the file may be complete by now
            native._TRIED = False
        if native.available():
            return native
        if time.monotonic() >= deadline:
            break
        time.sleep(pause)
    assert native.available(), "the JAX package's native image library did not load"
    return native


def _poison():
    """The state a process is left in when it loses the build race."""
    from tvc import native

    native._TRIED, native._LIB = True, None
    assert not native.available()


def test_recovers_from_a_lost_build_race():
    _poison()
    native = jax_native_ready()
    assert native._LIB is not None and native.available()


def test_asserts_when_the_library_never_loads(monkeypatch):
    from tvc import native

    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_LIB", None)
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="did not load"):
        jax_native_ready(timeout=0.3, pause=0.05)
    assert time.monotonic() - t0 < 5.0
