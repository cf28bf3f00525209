"""The Go-style channels, select and go (`paddle_tpu_torch.concurrency`):
the JAX package's `tests/test_concurrency_api.py` cases, each run on both
modules. Every blocking call takes a timeout, so that a hang fails fast.
"""

import time

import pytest

import paddle_tpu.concurrency as jcon

import paddle_tpu_torch.concurrency as tcon


@pytest.fixture(params=["jax", "torch"])
def m(request):
    """The concurrency module under test."""
    return jcon if request.param == "jax" else tcon


def test_the_port_has_the_jax_public_names():
    assert tcon.__all__ == jcon.__all__
    assert all(hasattr(tcon, n) for n in jcon.__all__)
    assert tcon.Channel is not jcon.Channel


class TestBufferedChannel:
    def test_fifo_order(self, m):
        ch = m.make_channel(capacity=4)
        for i in range(4):
            assert m.channel_send(ch, i)
        assert [m.channel_recv(ch)[0] for _ in range(4)] == [0, 1, 2, 3]

    def test_send_blocks_when_full_until_recv(self, m):
        ch = m.Channel(capacity=1)
        ch.send("a")
        got = []

        def sender():
            ch.send("b", timeout=5)
            got.append("sent")

        g = m.go(sender)
        time.sleep(0.05)
        assert not got          # blocked: buffer full
        assert ch.recv(timeout=5) == ("a", True)
        g.join(timeout=5)
        assert got == ["sent"]
        assert ch.recv(timeout=5) == ("b", True)

    def test_recv_blocks_until_send(self, m):
        ch = m.Channel(capacity=1)
        out = []
        g = m.go(lambda: out.append(ch.recv(timeout=5)))
        time.sleep(0.05)
        assert not out
        ch.send(42, timeout=5)
        g.join(timeout=5)
        assert out == [(42, True)]

    def test_close_semantics(self, m):
        ch = m.Channel(capacity=2)
        ch.send(1)
        ch.close()
        # drained values still readable after close (m.Go semantics)
        assert ch.recv(timeout=5) == (1, True)
        assert ch.recv(timeout=5) == (None, False)
        with pytest.raises(m.ChannelClosedError):
            ch.send(2)

    def test_close_wakes_blocked_receivers(self, m):
        ch = m.Channel(capacity=1)
        results = []
        gs = [m.go(lambda: results.append(ch.recv(timeout=5)))
              for _ in range(3)]
        time.sleep(0.05)
        m.channel_close(ch)
        for g in gs:
            g.join(timeout=5)
        assert results == [(None, False)] * 3


class TestUnbufferedChannel:
    def test_rendezvous(self, m):
        ch = m.Channel(capacity=0)
        order = []

        def sender():
            order.append("send-start")
            ch.send("x", timeout=5)
            order.append("send-done")

        g = m.go(sender)
        time.sleep(0.05)
        assert "send-done" not in order   # no receiver yet
        v, ok = ch.recv(timeout=5)
        g.join(timeout=5)
        assert (v, ok) == ("x", True)
        assert order == ["send-start", "send-done"]

    def test_many_producers_one_consumer(self, m):
        ch = m.Channel(capacity=0)
        n = 8
        gs = [m.go(ch.send, i, timeout=5) for i in range(n)]
        got = sorted(ch.recv(timeout=5)[0] for _ in range(n))
        for g in gs:
            g.join(timeout=5)
        assert got == list(range(n))

    def test_close_raises_for_blocked_sender(self, m):
        ch = m.Channel(capacity=0)
        g = m.go(ch.send, "never", timeout=5)
        time.sleep(0.05)
        ch.close()
        with pytest.raises(m.ChannelClosedError):
            g.join(timeout=5)


class TestSelect:
    def test_picks_ready_recv(self, m):
        a, b = m.Channel(capacity=1), m.Channel(capacity=1)
        b.send("from-b")
        fired = []
        sel = (m.Select()
               .case_recv(a, lambda v, ok: fired.append(("a", v)))
               .case_recv(b, lambda v, ok: fired.append(("b", v))))
        which = sel.run(timeout=5)
        assert which == 1 and fired == [("b", "from-b")]

    def test_default_when_nothing_ready(self, m):
        a = m.Channel(capacity=1)   # empty: recv not ready
        fired = []
        which = (m.Select()
                 .case_recv(a, lambda v, ok: fired.append("recv"))
                 .default(lambda: fired.append("default"))).run()
        assert which == -1 and fired == ["default"]

    def test_send_case(self, m):
        a = m.Channel(capacity=1)
        fired = []
        which = (m.Select()
                 .case_send(a, 7, lambda: fired.append("sent"))).run(timeout=5)
        assert which == 0 and fired == ["sent"]
        assert a.recv(timeout=5) == (7, True)

    def test_timeout(self, m):
        a = m.Channel(capacity=1)
        with pytest.raises(TimeoutError):
            m.Select().case_recv(a, lambda v, ok: None).run(timeout=0.05)

    def test_producer_consumer_pipeline(self, m):
        # ≙ the reference's CSP fibonacci/pipeline examples
        nums, done = m.Channel(capacity=0), m.Channel(capacity=0)

        def producer():
            for i in range(10):
                nums.send(i, timeout=5)
            nums.close()

        total = []

        def consumer():
            while True:
                v, ok = nums.recv(timeout=5)
                if not ok:
                    break
                total.append(v)
            done.send(sum(total), timeout=5)

        gp, gc = m.go(producer), m.go(consumer)
        s, ok = done.recv(timeout=10)
        assert ok and s == 45
        gp.join(timeout=5)
        gc.join(timeout=5)


class TestSelectRendezvous:
    def test_two_selects_rendezvous_on_unbuffered(self, m):
        """Regression: a send-select and a recv-select on the same
        unbuffered channel must complete (m.Go semantics), even though
        neither side is 'ready' until the other commits."""
        ch = m.Channel(capacity=0)
        got = []

        def recv_side():
            m.Select().case_recv(ch, lambda v, ok: got.append(v)).run(timeout=10)

        def send_side():
            m.Select().case_send(ch, 42, lambda: got.append("sent")).run(
                timeout=10)

        g1, g2 = m.go(recv_side), m.go(send_side)
        g1.join(timeout=15)
        g2.join(timeout=15)
        assert sorted(map(str, got)) == ["42", "sent"]

    def test_recv_timeout_distinct_from_close(self, m):
        ch = m.Channel(capacity=1)
        with pytest.raises(m.ChannelTimeout):
            ch.recv(timeout=0.05)      # slow producer != end-of-stream
        ch.close()
        assert ch.recv(timeout=0.05) == (None, False)  # real close

    def test_unbuffered_send_timeout_bounded(self, m):
        ch = m.Channel(capacity=0)
        t0 = time.time()
        assert ch.send("x", timeout=0.2) is False
        assert time.time() - t0 < 0.8   # single deadline, not 2x


class TestGo:
    def test_decorator_and_result(self, m):
        @m.Go
        def work():
            return 21 * 2
        assert work.join(timeout=5) == 42

    def test_exception_propagates_on_join(self, m):
        def boom():
            raise ValueError("boom")
        g = m.go(boom)
        with pytest.raises(ValueError):
            g.join(timeout=5)
