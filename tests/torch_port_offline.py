"""The guard of the data-production tests: no test reaches the network or a
downloader, and none runs for long. Import its fixtures into a test module:

    from torch_port_offline import offline, one_cv2_thread  # noqa: F401

Per test: ``socket.socket.connect``, ``socket.create_connection`` and
``socket.getaddrinfo`` raise ``OSError("offline test")`` (a missed stub fails
in milliseconds; ``file://`` URLs open without a socket); both packages'
``youtube_utils._downloader`` find no ``yt-dlp``/``youtube-dl`` (a test of
the download path stubs ``subprocess.run`` or ``download_video`` itself); a
``SIGALRM`` after ``TEST_SECONDS`` raises ``TimeLimitExceeded`` in the test, and
after ``HANG_SECONDS`` ``faulthandler`` prints every thread's stack and ends
the worker (a hang inside C code takes down its worker, not the run). Per
module: ``cv2`` on one thread, as ``torch_port_threads`` does for torch.
"""

import faulthandler
import signal
import socket

import pytest

TEST_SECONDS = 60
HANG_SECONDS = 90


class TimeLimitExceeded(Exception):
    pass


def _refuse(*args, **kwargs):
    raise OSError("offline test")


def _alarm(signum, frame):
    raise TimeLimitExceeded(f"the test ran past {TEST_SECONDS} s")


@pytest.fixture(scope="module", autouse=True)
def one_cv2_thread():
    """cv2's pool at one thread for the module."""
    import cv2

    threads = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(threads)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setattr(socket.socket, "connect", _refuse)
    monkeypatch.setattr(socket, "create_connection", _refuse)
    monkeypatch.setattr(socket, "getaddrinfo", _refuse)
    from vince_tpu.utils import youtube_utils as reference
    from vince_tpu_torch.utils import youtube_utils

    for module in (youtube_utils, reference):
        monkeypatch.setattr(module, "_downloader", lambda: None)
    previous = signal.signal(signal.SIGALRM, _alarm)
    signal.setitimer(signal.ITIMER_REAL, TEST_SECONDS)
    faulthandler.dump_traceback_later(HANG_SECONDS, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
