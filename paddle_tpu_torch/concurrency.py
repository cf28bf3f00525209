"""CSP concurrency: Go-style channels, select, go.

≙ paddle_tpu/concurrency.py (reference framework/channel.h:33 /
channel_impl.h: buffered and unbuffered channels with close semantics;
the channel_create / send / recv / close operators, select_op.cc,
go_op.cc, and the Python surface fluid/concurrency.py:28,196,282).

The reference threads channels through programs, executed by
interpreting executors. Here, as in the JAX package, they coordinate host
threads: input pipelines feeding a training loop, checkpoint writers,
parameter services. The semantics are Go's: unbuffered channels
rendezvous; receive on a closed, drained channel returns (None, False);
send on a closed channel raises; select picks uniformly among ready cases
and supports a default. Every blocking call takes a timeout.
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Any, Callable, List, Optional, Sequence, Tuple

from .core.enforce import InvalidArgumentError, enforce

__all__ = ["Channel", "ChannelClosedError", "ChannelTimeout", "Go", "Select",
           "channel_close", "channel_recv", "channel_send", "go",
           "make_channel"]


class ChannelClosedError(RuntimeError):
    """Send on a closed channel (≙ PADDLE_ENFORCE in ChannelImpl::Send)."""


class ChannelTimeout(TimeoutError):
    """recv/send gave up after `timeout` — distinct from close so drain
    loops (`while ok`) can't mistake a slow producer for end-of-stream."""


class Channel:
    """Buffered (capacity > 0) or unbuffered (capacity == 0) channel
    (≙ ChannelImpl, reference framework/channel_impl.h)."""

    def __init__(self, capacity: int = 0, dtype=None, name: str = ""):
        enforce(capacity >= 0, "channel capacity must be >= 0",
                exc=InvalidArgumentError)
        self.capacity = capacity
        self.dtype = dtype
        self.name = name
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        # unbuffered rendezvous bookkeeping: parked senders / receivers
        self._recv_waiting = 0
        self._send_waiting = 0

    # -- probes used by Select (called under no lock; advisory) -----------
    def _can_send(self) -> bool:
        if self._closed:
            return True   # send will raise — still "ready" so select surfaces it
        if self.capacity > 0:
            return len(self._buf) < self.capacity
        return self._recv_waiting > 0

    def _can_recv(self) -> bool:
        return bool(self._buf) or self._closed or self._send_waiting > 0

    # -- core ops ---------------------------------------------------------
    def send(self, value: Any, timeout: Optional[float] = None) -> bool:
        """Blocks until delivered (unbuffered: until a receiver takes it).
        Raises ChannelClosedError if the channel is/becomes closed.
        Returns False on timeout; `timeout` bounds the WHOLE call."""
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout

        def remaining():
            if deadline is None:
                return None
            return max(deadline - _time.monotonic(), 0.0)

        with self._cond:
            if self._closed:
                raise ChannelClosedError(f"send on closed channel {self.name}")
            if self.capacity > 0:
                ok = self._cond.wait_for(
                    lambda: self._closed or len(self._buf) < self.capacity,
                    remaining())
                if not ok:
                    return False
                if self._closed:
                    raise ChannelClosedError(
                        f"send on closed channel {self.name}")
                self._buf.append(value)
                self._cond.notify_all()
                return True
            # unbuffered rendezvous: advertise the blocked sender, wait for
            # a receiver + empty slot, park a tokened value, wait for pickup
            self._send_waiting += 1
            self._cond.notify_all()
            try:
                ok = self._cond.wait_for(
                    lambda: self._closed or (self._recv_waiting > 0
                                             and not self._buf), remaining())
                if not ok:
                    return False
                if self._closed:
                    raise ChannelClosedError(
                        f"send on closed channel {self.name}")
                token = object()
                self._buf.append((token, value))
                self._cond.notify_all()
                self._cond.wait_for(
                    lambda: self._closed or not any(
                        t is token for t, _ in self._buf), remaining())
                still_parked = any(t is token for t, _ in self._buf)
                if still_parked:
                    self._buf = deque((t, v) for t, v in self._buf
                                      if t is not token)
                    if self._closed:
                        raise ChannelClosedError(
                            f"send on closed channel {self.name}")
                    return False   # timeout before rendezvous completed
                return True
            finally:
                self._send_waiting -= 1

    def recv(self, timeout: Optional[float] = None) -> Tuple[Any, bool]:
        """Blocks for a value. Returns (value, True), or (None, False) ONLY
        once the channel is closed and drained (Go semantics; ≙ Receive
        returning false, channel_impl.h). A timeout raises ChannelTimeout so
        drain loops can't mistake a slow producer for end-of-stream."""
        with self._cond:
            self._recv_waiting += 1
            self._cond.notify_all()
            try:
                ok = self._cond.wait_for(
                    lambda: self._buf or self._closed, timeout)
                if not ok:
                    raise ChannelTimeout(
                        f"recv on channel {self.name!r} timed out "
                        f"after {timeout}s")
                if self._buf:
                    v = self._buf.popleft()
                    if self.capacity == 0:
                        v = v[1]          # unwrap (token, value)
                    self._cond.notify_all()
                    return v, True
                return None, False    # closed and drained
            finally:
                self._recv_waiting -= 1

    def close(self):
        """Wake all blocked senders/receivers (≙ ChannelImpl::Close)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self):
        with self._lock:
            return len(self._buf)


def make_channel(dtype=None, capacity: int = 0, name: str = "") -> Channel:
    """≙ fluid.concurrency.make_channel (concurrency.py:282)."""
    return Channel(capacity=capacity, dtype=dtype, name=name)


def channel_send(channel: Channel, value, timeout=None) -> bool:
    return channel.send(value, timeout=timeout)


def channel_recv(channel: Channel, timeout=None) -> Tuple[Any, bool]:
    return channel.recv(timeout=timeout)


def channel_close(channel: Channel):
    channel.close()


class Go:
    """Run a block concurrently (≙ go_op.cc / fluid.concurrency.Go:28).
    Usable as a decorator or context manager:

        @Go
        def producer(): ...
        producer.join()
    """

    def __init__(self, fn: Callable = None):
        self._thread: Optional[threading.Thread] = None
        self.result = None
        self.exception: Optional[BaseException] = None
        if fn is not None:
            self._start(fn)

    def _start(self, fn, *args, **kwargs):
        def run():
            try:
                self.result = fn(*args, **kwargs)
            except BaseException as e:  # surfaced on join
                self.exception = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None):
        if self._thread:
            self._thread.join(timeout)
        if self.exception is not None:
            raise self.exception
        return self.result


def go(fn: Callable, *args, **kwargs) -> Go:
    """go(fn, ...) — launch fn concurrently, return the handle."""
    g = Go.__new__(Go)
    g._thread = None
    g.result = None
    g.exception = None
    g._start(fn, *args, **kwargs)
    return g


class Select:
    """Multi-way channel select (≙ select_op.cc / fluid.concurrency.Select
    :196). Build cases then run():

        sel = Select()
        sel.case_recv(ch_a, lambda v, ok: ...)
        sel.case_send(ch_b, value, lambda: ...)
        sel.default(lambda: ...)          # optional, makes run() non-blocking
        which = sel.run(timeout=...)      # index of the fired case

    Ready-case choice is uniformly random (Go fairness).
    """

    _POLL_S = 0.0005

    def __init__(self):
        self._cases: List[tuple] = []
        self._default: Optional[Callable] = None

    def case_recv(self, ch: Channel, body: Callable[[Any, bool], Any]):
        self._cases.append(("recv", ch, None, body))
        return self

    def case_send(self, ch: Channel, value, body: Callable[[], Any]):
        self._cases.append(("send", ch, value, body))
        return self

    def default(self, body: Callable[[], Any]):
        self._default = body
        return self

    def run(self, timeout: Optional[float] = None) -> int:
        """Execute one ready case; returns its index (-1 for default).
        Raises TimeoutError when nothing becomes ready in `timeout`."""
        enforce(self._cases or self._default is not None,
                "select with no cases", exc=InvalidArgumentError)
        import time

        def attempt(i):
            """Try case i with a tiny timeout; return True if it fired."""
            kind, ch, value, body = self._cases[i]
            if kind == "recv":
                try:
                    v, ok = ch.recv(timeout=self._POLL_S)
                except ChannelTimeout:
                    return False   # lost the race; retry
                body(v, ok)
                return True
            try:
                sent = ch.send(value, timeout=self._POLL_S)
            except ChannelClosedError:
                raise            # surfaced to the caller, like Go's panic
            if sent:
                body()
                return True
            return False

        deadline = None if timeout is None else time.time() + timeout
        while True:
            ready = [i for i, (kind, ch, _, _) in enumerate(self._cases)
                     if (ch._can_recv() if kind == "recv"
                         else ch._can_send())]
            if ready:
                i = random.choice(ready)
                if attempt(i):
                    return i
            elif self._default is not None:
                self._default()
                return -1
            else:
                # nothing advertises readiness — actively attempt each case
                # briefly so two selects (send-side and recv-side) on an
                # unbuffered channel still rendezvous
                order = list(range(len(self._cases)))
                random.shuffle(order)
                fired = False
                for i in order:
                    if attempt(i):
                        fired = True
                        break
                if fired:
                    return i
            if deadline is not None and time.time() >= deadline:
                raise TimeoutError("select timed out")
