"""The port's ``GPU`` leases on a node of two cards, declared through
``RAY_TPU_TORCH_GPUS`` so this runs on the CPU: the raylet binds each lease
to its own cards, and the worker that runs it sees only them through
``CUDA_VISIBLE_DEVICES``. Every cluster call carries its own timeout."""

import os
import time

import pytest

import ray_tpu_torch

T = 60  # seconds, each cluster call


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    saved = os.environ.get("RAY_TPU_TORCH_GPUS")
    os.environ["RAY_TPU_TORCH_GPUS"] = "2"  # the raylet detects two cards
    try:
        ray_tpu_torch.init(num_cpus=4)
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_GPUS")
        else:
            os.environ["RAY_TPU_TORCH_GPUS"] = saved
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_cpus=0)
class Holder:
    def cards(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_two_gpu_actors_get_different_cards(cluster):
    """Two ``num_gpus=1`` actors run on the two cards, one each; a third
    waits for a card and gets the one the killed actor gave back."""
    a = Holder.options(num_gpus=1).remote()
    b = Holder.options(num_gpus=1).remote()
    got = ray_tpu_torch.get([a.cards.remote(), b.cards.remote()], timeout=T)
    assert sorted(got) == ["0", "1"]
    c = Holder.options(num_gpus=1).remote()
    pending = c.cards.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3.0)
    assert ready == []
    ray_tpu_torch.kill(a)
    assert ray_tpu_torch.get(pending, timeout=T) == got[0]
    for h in (b, c):
        ray_tpu_torch.kill(h)


def test_shares_of_a_card_pack_before_a_whole_card(cluster):
    """Two half-card actors share one card, a whole-card actor takes the
    other, and a further half waits until a card has a half free."""
    halves = [Holder.options(num_gpus=0.5).remote() for _ in range(2)]
    half_cards = ray_tpu_torch.get([h.cards.remote() for h in halves],
                                   timeout=T)
    assert len(set(half_cards)) == 1
    whole = Holder.options(num_gpus=1).remote()
    whole_card = ray_tpu_torch.get(whole.cards.remote(), timeout=T)
    assert {whole_card, half_cards[0]} == {"0", "1"}
    late = Holder.options(num_gpus=0.5).remote()
    pending = late.cards.remote()
    ready, _ = ray_tpu_torch.wait([pending], timeout=3.0)
    assert ready == []
    ray_tpu_torch.kill(halves[0])
    assert ray_tpu_torch.get(pending, timeout=T) == half_cards[0]
    for h in (halves[1], whole, late):
        ray_tpu_torch.kill(h)


def test_gpu_tasks_see_one_card_each_and_cpu_tasks_none_bound(cluster):
    """A ``num_gpus=1`` task sees one of the node's cards; a task without
    cards runs in a worker the raylet did not bind; the cards come back
    when the leases do."""
    @ray_tpu_torch.remote(num_gpus=1)
    def on_card():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote
    def on_cpu():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    got = ray_tpu_torch.get([on_card.remote() for _ in range(4)], timeout=T)
    assert set(got) <= {"0", "1"}
    assert ray_tpu_torch.get(on_cpu.remote(), timeout=T) \
        == os.environ.get("CUDA_VISIBLE_DEVICES")
    deadline = time.monotonic() + T  # the owner returns idle leases
    while ray_tpu_torch.available_resources().get("GPU") != 2.0:
        assert time.monotonic() < deadline
        time.sleep(0.1)
