"""A mirror of ``tests/test_pull_priority.py`` on the port's runtime
(``ray_tpu_torch``, on the CPU): the same scenarios and assertions.

Prioritized pull admission (reference: object_manager/pull_manager.cc:
get > task-arg > background classes, priority upgrades, obsolete-pull
cancellation)."""

import asyncio

from ray_tpu_torch._private.pull_manager import (PRIO_ARG,
                                                 PRIO_BACKGROUND, PRIO_GET,
                                                 PullQueue)


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_priority_order_beats_fifo():
    """With one slot busy, a later-arriving GET pull is admitted before an
    earlier-queued BACKGROUND pull."""

    async def main():
        q = PullQueue(slots=1)
        order = []

        async def pull(oid, prio, hold=0.05):
            q.request(oid, prio)
            assert await q.admit(oid)
            order.append(oid)
            await asyncio.sleep(hold)
            q.release(oid)

        first = asyncio.ensure_future(pull(b"hold", PRIO_ARG))
        await asyncio.sleep(0.01)  # occupies the slot
        bg = asyncio.ensure_future(pull(b"bg", PRIO_BACKGROUND))
        await asyncio.sleep(0.01)  # bg queued first...
        hot = asyncio.ensure_future(pull(b"hot", PRIO_GET))
        await asyncio.gather(first, bg, hot)
        assert order == [b"hold", b"hot", b"bg"], order

    _run(main())


def test_fifo_within_class():
    async def main():
        q = PullQueue(slots=1)
        order = []

        async def pull(oid):
            q.request(oid, PRIO_ARG)
            assert await q.admit(oid)
            order.append(oid)
            await asyncio.sleep(0.02)
            q.release(oid)

        tasks = [asyncio.ensure_future(pull(f"o{i}".encode()))
                 for i in range(4)]
        await asyncio.gather(*tasks)
        assert order == [b"o0", b"o1", b"o2", b"o3"], order

    _run(main())


def test_priority_upgrade():
    """A queued background pull upgraded by a hot requester is admitted
    ahead of mid-priority arrivals."""

    async def main():
        q = PullQueue(slots=1)
        order = []
        # the first pull keeps the slot until the upgrade is in: on a busy
        # host the sleeps below can outlast its hold, and "mid" would be
        # admitted before the upgrade was made
        upgraded = asyncio.Event()

        async def pull(oid, prio, gate=None):
            q.request(oid, prio)
            assert await q.admit(oid)
            order.append(oid)
            if gate is not None:
                await gate.wait()
            await asyncio.sleep(0.02)
            q.release(oid)

        hold = asyncio.ensure_future(pull(b"hold", PRIO_ARG, upgraded))
        await asyncio.sleep(0.01)
        bg = asyncio.ensure_future(pull(b"bg", PRIO_BACKGROUND))
        mid = asyncio.ensure_future(pull(b"mid", PRIO_ARG))
        await asyncio.sleep(0.01)
        q.request(b"bg", PRIO_GET)  # upgrade: a get now needs it
        upgraded.set()
        await asyncio.gather(hold, bg, mid)
        assert order == [b"hold", b"bg", b"mid"], order

    _run(main())


def test_stale_pull_cancelled_without_waiters():
    async def main():
        q = PullQueue(slots=1, stale_ttl_s=0.2)

        async def hold():
            q.request(b"hold", PRIO_ARG)
            assert await q.admit(b"hold")
            await asyncio.sleep(1.2)
            q.release(b"hold")

        async def stale():
            q.request(b"stale", PRIO_ARG)  # no waiter ever asserts interest
            return await q.admit(b"stale")

        h = asyncio.ensure_future(hold())
        await asyncio.sleep(0.01)
        admitted = await stale()
        assert admitted is False  # cancelled as obsolete, never transferred
        await h

    _run(main())


def test_waiter_keeps_pull_alive():
    async def main():
        q = PullQueue(slots=1, stale_ttl_s=0.2)

        async def hold():
            q.request(b"hold", PRIO_ARG)
            assert await q.admit(b"hold")
            await asyncio.sleep(0.9)
            q.release(b"hold")

        async def wanted():
            q.request(b"wanted", PRIO_ARG)
            q.add_waiter(b"wanted")  # a getter is actively blocked on it
            return await q.admit(b"wanted")

        h = asyncio.ensure_future(hold())
        await asyncio.sleep(0.01)
        assert await wanted() is True
        q.release(b"wanted")
        await h

    _run(main())
