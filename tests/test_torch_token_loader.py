"""The port's token-file loader (``ray_tpu_torch/data/token_loader.py``)
against the JAX package's (``ray_tpu/data/token_loader.py``), on the same
token files.

The port's native ring hands batches out in fill order, so its batch k is
the k-th draw of the seeded stream at every ring size and consumer timing:
its sequence equals the JAX numpy route's. The JAX native ring's order
depends on thread timing at 3 buffers (its ``dl_next`` hands out the lowest
filled slot), so only its first batch is compared.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

pytest.importorskip("flax")  # the JAX reference; the card's machine lacks it

from ray_tpu.data.token_loader import TokenFileLoader as JaxLoader  # noqa: E402
from ray_tpu_torch._private import native_build  # noqa: E402
from ray_tpu_torch.data import (TokenFileLoader, to_device,  # noqa: E402
                                write_token_file)
from ray_tpu_torch.data import token_loader  # noqa: E402


@pytest.fixture
def corpus(tmp_path):
    tokens = np.arange(100_000, dtype=np.int32) % 32000
    path = str(tmp_path / "corpus.bin")
    write_token_file(path, tokens)
    return path, tokens


def _random_corpus(tmp_path, token_bytes):
    rng = np.random.default_rng(token_bytes)
    hi = 60000 if token_bytes == 2 else 32000
    path = str(tmp_path / f"random{token_bytes}.bin")
    write_token_file(path, rng.integers(0, hi, 50_000), token_bytes)
    return path


def test_native_build_and_sample(corpus):
    path, tokens = corpus
    with TokenFileLoader(path, batch=4, seq=128, seed=7) as loader:
        assert loader.native
        assert loader.num_tokens == len(tokens)
        batch = loader.next_batch()
        assert batch["tokens"].shape == (4, 128)
        assert batch["targets"].shape == (4, 128)
        assert batch["tokens"].dtype == np.int32
        # rows are consecutive corpus slices: the corpus is arange % 32000,
        # so successive tokens differ by 1 (mod 32000)
        t, y = batch["tokens"], batch["targets"]
        assert np.all(y[:, :-1] == t[:, 1:])
        diffs = np.diff(t.astype(np.int64), axis=1) % 32000
        assert np.all(diffs == 1), "rows are not consecutive corpus slices"


def test_single_buffer_ring_does_not_deadlock(corpus):
    path, _ = corpus
    with TokenFileLoader(path, batch=2, seq=32, seed=5, n_buffers=1) as loader:
        for _ in range(3):
            assert loader.next_batch()["tokens"].shape == (2, 32)


def test_prefetch_overlaps(corpus):
    path, _ = corpus
    with TokenFileLoader(path, batch=8, seq=512, seed=1, n_buffers=3) as loader:
        loader.next_batch()
        deadline = time.monotonic() + 5.0
        # the background thread refills the ring while nothing is drawn
        while loader.batches_produced() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loader.batches_produced() >= 3


def test_seeded_determinism(corpus):
    path, _ = corpus
    runs = []
    for _ in range(2):
        with TokenFileLoader(path, batch=4, seq=64, seed=42) as loader:
            runs.append([loader.next_batch()["tokens"].copy()
                         for _ in range(6)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_python_route_matches_api(corpus):
    path, _ = corpus
    loader = TokenFileLoader(path, batch=2, seq=32, seed=3, force_python=True)
    assert not loader.native
    batch = loader.next_batch()
    assert batch["tokens"].shape == (2, 32)
    assert np.all(batch["targets"][:, :-1] == batch["tokens"][:, 1:])
    assert loader.batches_produced() == 1


def test_uint16_tokens(tmp_path):
    tokens = (np.arange(10_000) % 60000).astype(np.uint16)
    path = str(tmp_path / "c16.bin")
    write_token_file(path, tokens, token_bytes=2)
    with TokenFileLoader(path, batch=2, seq=16, token_bytes=2) as loader:
        assert loader.num_tokens == len(tokens)
        batch = loader.next_batch()
        assert batch["tokens"].dtype == np.int32
        assert batch["tokens"].max() < 60000


@pytest.mark.parametrize("token_bytes", [4, 2], ids=["int32", "uint16"])
@pytest.mark.parametrize("n_buffers", [1, 2, 3, 4])
def test_sequence_equals_jax_python_route_under_delays(tmp_path, n_buffers,
                                                       token_bytes):
    """The first 12 batches of the port's native ring, drawn by a consumer
    that sleeps at random between batches, are the JAX numpy route's 12."""
    path = _random_corpus(tmp_path, token_bytes)
    ref = JaxLoader(path, batch=3, seq=40, seed=42, token_bytes=token_bytes,
                    force_python=True)
    want = [ref.next_batch() for _ in range(12)]
    sleeps = np.random.default_rng(n_buffers).uniform(0, 4e-3, 12)
    with TokenFileLoader(path, batch=3, seq=40, seed=42, n_buffers=n_buffers,
                         token_bytes=token_bytes) as loader:
        assert loader.native
        for k, pause in enumerate(sleeps):
            batch = loader.next_batch()
            for key in ("tokens", "targets", "mask"):
                np.testing.assert_array_equal(
                    batch[key], want[k][key], err_msg=f"batch {k}, {key}")
            time.sleep(pause)


def test_first_batch_equals_jax_native(corpus):
    path, _ = corpus
    with JaxLoader(path, batch=4, seq=64, seed=9) as ref:
        assert ref.native, "the JAX package's native loader did not build"
        want = ref.next_batch()["tokens"].copy()
    with TokenFileLoader(path, batch=4, seq=64, seed=9) as loader:
        np.testing.assert_array_equal(loader.next_batch()["tokens"], want)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build_and_load(str(bad), "broken")
    assert not any(n.endswith(".so")
                   for n in os.listdir(tmp_path / "build"))
    # the loader raises with it: no silent numpy route
    monkeypatch.setattr(token_loader, "_SRC", str(bad))
    corpus = str(tmp_path / "c.bin")
    write_token_file(corpus, np.arange(1000))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TokenFileLoader(corpus, batch=2, seq=16)


def test_unreadable_file_raises(tmp_path):
    with pytest.raises(ValueError, match="cannot open"):
        TokenFileLoader(str(tmp_path / "missing.bin"), batch=2, seq=16)


def test_to_device_copies(corpus):
    path, _ = corpus
    with TokenFileLoader(path, batch=2, seq=32, seed=4, n_buffers=1) as loader:
        batch = loader.next_batch()
        first = batch["tokens"].copy()
        moved = to_device(batch, torch.device("cpu"))
        loader.next_batch()  # the ring's one buffer is refilled
        np.testing.assert_array_equal(moved["tokens"].numpy(), first)
        assert moved["tokens"].dtype == torch.int32


def test_feeds_train_step(corpus):
    """Native loader -> the port's TrainStepBundle on the CPU (the tiny
    config, whose vocabulary is 256 tokens)."""
    from ray_tpu_torch.models import CONFIGS
    from ray_tpu_torch.parallel import TrainStepBundle

    path, _ = corpus
    bundle = TrainStepBundle(dataclasses.replace(CONFIGS["tiny"],
                                                 dtype=torch.float32),
                             device="cpu")
    params, opt = bundle.init(seed=0)
    losses = []
    with TokenFileLoader(path, batch=4, seq=64, seed=0) as loader:
        for _, batch in zip(range(3), loader.batches()):
            batch = {k: v % 256 if k != "mask" else v
                     for k, v in batch.items()}
            params, opt, loss = bundle.step(params, opt,
                                            to_device(batch, bundle.device))
            losses.append(loss.item())
    assert np.all(np.isfinite(losses))
    assert opt.count == 3
