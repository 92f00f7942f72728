"""The port's streaming Dataset (``ray_tpu_torch/data``) on a port cluster,
on the CPU, against the JAX package's on a JAX cluster: a mirror of
``tests/test_data.py``, each pipeline built the same way on both packages'
data modules from the same seeded inputs. Rows are equal (in order where
the JAX package keeps one), batches are equal with the same dtypes, and a
parquet file written by one package reads back in the other. The port's
columnar block is held against the JAX block (a pyarrow ``Table``) on the
same rows and batches: the same rows back, the same batch dtypes and
values, the same fallback to a list block.

Every JAX-side call runs under a timeout (``jax_side``). Nothing here
imports JAX or the JAX package at module level: the port's workers may
import this module."""

import math
import os
import threading

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as pdata
from ray_tpu_torch.data.block import BlockAccessor, Table

T = 60  # seconds, each call of either package


@pytest.fixture(scope="module")
def clusters():
    pytest.importorskip("pyarrow")  # the JAX package's blocks
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=6, device="cpu")
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def jax_side(fn, timeout=T):
    """``fn()`` on a thread, failing the test if it outlasts ``timeout``."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # surface in the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"the JAX side took more than {timeout} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def both(build, consume=lambda ds: ds.take_all()):
    """(JAX result, port result) of ``consume(build(data_module))``."""
    import ray_tpu.data as jdata

    return jax_side(lambda: consume(build(jdata))), consume(build(pdata))


def assert_same_batches(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert list(w) == list(g)
        for k in w:
            assert w[k].dtype == g[k].dtype, (k, w[k].dtype, g[k].dtype)
            assert repr(w[k].tolist()) == repr(g[k].tolist()), k


def test_range_map_filter_take(clusters):
    def build(rd):
        ds = rd.range(100, parallelism=4).map(lambda r: {"id": r["id"] * 2})
        return ds.filter(lambda r: r["id"] % 4 == 0)

    want, got = both(build, lambda ds: (ds.take(5), ds.count()))
    assert got == want
    assert [r["id"] for r in got[0]] == [0, 4, 8, 12, 16] and got[1] == 50


def test_map_batches(clusters):
    def build(rd):
        return rd.range(64, parallelism=2).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_size=16)

    want, got = both(build)
    assert got == want and len(got) == 64 and got[5]["sq"] == 25


def test_flat_map_and_union(clusters):
    def build(rd):
        a = rd.from_items([{"x": 1}, {"x": 2}], parallelism=1)
        b = a.flat_map(lambda r: [r, r])
        return a, b

    want, got = both(build, lambda ab: (
        ab[1].take_all(), ab[1].count(), ab[0].union(ab[1]).count(),
        sorted(r["x"] for r in ab[0].union(ab[1]).take_all())))
    assert got == want and got[1] == 4 and got[2] == 6


def test_iter_batches_shapes(clusters):
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(50).astype(np.float32)

    def build(rd):
        return rd.range(50, parallelism=3).map_batches(
            lambda b, v=vals: {"id": b["id"], "x": v[b["id"]],
                               "tag": np.array([f"t{i}" for i in b["id"]])})

    want, got = both(build, lambda ds: list(ds.iter_batches(batch_size=16)))
    assert_same_batches(want, got)
    sizes = [len(b["id"]) for b in got]
    assert sum(sizes) == 50 and all(s == 16 for s in sizes[:-1])
    # float32 rows rebuild as float64, as the JAX batches do
    assert got[0]["x"].dtype == np.float64
    want, got = both(build, lambda ds: list(ds.iter_batches(
        batch_size=16, drop_last=True)))
    assert_same_batches(want, got)
    assert len(got) == 3

    # numbers alone: the port cuts the batches from the blocks' columns
    def numeric(rd):
        return rd.range(50, parallelism=3).map_batches(
            lambda b, v=vals: {"x": v[b["id"]], "i": b["id"].astype(np.int32),
                               "u": (b["id"] % 3).astype(np.uint8),
                               "flag": b["id"] % 2 == 0})

    for bs in (16, 7, 64):
        want, got = both(numeric, lambda ds: list(ds.iter_batches(
            batch_size=bs)))
        assert_same_batches(want, got)


def test_repartition_and_split(clusters):
    want, got = both(lambda rd: rd.range(40, parallelism=3).repartition(4),
                     lambda ds: (ds.num_blocks(),
                                 sorted(r["id"] for r in ds.take_all())))
    assert got == want == (4, list(range(40)))

    def parts(ds):
        return [p.take_all() for p in ds.split(4)]

    want, got = both(lambda rd: rd.range(40, parallelism=2), parts)
    assert got == want
    assert [len(p) for p in got] == [10] * 4


def test_random_shuffle(clusters):
    want, got = both(lambda rd: rd.range(30, parallelism=2).random_shuffle(
        seed=42), lambda ds: [r["id"] for r in ds.take_all()])
    assert sorted(got) == sorted(want) == list(range(30))
    assert got != list(range(30))


def test_parquet_roundtrip(clusters, tmp_path):
    """Each package writes parquet; each reads what either wrote."""
    import ray_tpu.data as jdata

    def build(rd):
        return rd.range(20, parallelism=2).map(
            lambda r: {"id": r["id"], "y": r["id"] * 1.5,
                       "s": None if r["id"] % 5 == 0 else f"s{r['id']}"})

    jfiles = jax_side(lambda: build(jdata).write_parquet(str(tmp_path / "j")))
    pfiles = build(pdata).write_parquet(str(tmp_path / "p"))
    assert len(jfiles) == len(pfiles) == 2
    rows = {}
    for src in ("j", "p"):
        path = str(tmp_path / src)
        rows["jax reads " + src] = jax_side(
            lambda: jdata.read_parquet(path).take_all())
        rows["port reads " + src] = pdata.read_parquet(path).take_all()
    want = build(pdata).take_all()
    for name, got in rows.items():
        assert got == want, name
    assert pdata.read_parquet(str(tmp_path / "j")).to_pandas()["y"].sum() \
        == sum(i * 1.5 for i in range(20))


def test_from_pandas_and_numpy(clusters):
    import pandas as pd

    df = pd.DataFrame({"a": [1, 2, 3], "y": [1.5, math.nan, 2.0],
                       "s": ["x", None, "z"]})
    want, got = both(lambda rd: rd.from_pandas(df))
    assert got == want
    assert got[1] == {"a": 2, "y": None, "s": None}
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((4, 2))
    want, got = both(lambda rd: rd.from_numpy(arr))
    assert got == want and len(got) == 4
    want, got = both(lambda rd: rd.from_numpy(arr),
                     lambda ds: list(ds.iter_batches(batch_size=3)))
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert w["data"].dtype == g["data"].dtype == object
        for wc, gc in zip(w["data"], g["data"]):
            assert wc.dtype == gc.dtype and np.array_equal(wc, gc)
    df_back = pdata.from_pandas(df).to_pandas()
    assert list(df_back.columns) == ["a", "y", "s"]
    assert df_back["a"].tolist() == [1, 2, 3]


def test_train_integration_shards(clusters, tmp_path):
    """Dataset splits feed train workers via get_dataset_shard, each rank
    the rows the JAX split gives it."""
    import json

    import ray_tpu.data as jdata

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    want = jax_side(lambda: [sum(r["id"] for r in p.take_all())
                             for p in jdata.range(20, parallelism=2).split(2)])
    out_dir = str(tmp_path / "totals")
    os.makedirs(out_dir)

    def loop(config):
        import json as _json
        import os as _os

        from ray_tpu_torch import train

        shard = train.get_dataset_shard("train")
        total = sum(r["id"] for r in shard.take_all())
        rank = train.get_context().get_world_rank()
        with open(_os.path.join(config["out"], f"{rank}.json"), "w") as f:
            _json.dump(total, f)
        train.report({"total": total, "rank": rank})
        return total

    trainer = TorchTrainer(
        loop,
        train_loop_config={"out": out_dir},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1.0}),
        run_config=RunConfig(storage_path=str(tmp_path), name="shards"),
        datasets={"train": pdata.range(20, parallelism=2)},
    )
    result = trainer.fit()
    assert result.error is None
    got = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"{rank}.json")) as f:
            got.append(json.load(f))
    assert got == want == [45, 145]


# ---------------------------------------------------------------------------
# the port's block against the JAX block (pyarrow), without a cluster
# ---------------------------------------------------------------------------

ROW_CASES = {
    "ints and floats": [{"a": 1, "b": 2.5}, {"a": 2, "b": None}],
    "keys of the first row": [{"a": 1}, {"a": 2, "b": 3}],
    "missing values": [{"a": 1, "b": None}, {"b": 3}],
    "bools with a null": [{"x": True}, {"x": None}],
    "lists": [{"x": [1, 2]}, {"x": [3.5]}],
    "float32 arrays": [{"x": np.ones(2, np.float32)},
                       {"x": np.zeros(3, np.float32)}],
    "str beside bytes": [{"s": "a"}, {"s": b"b"}],
    "strings with a null": [{"s": "a"}, {"s": None}],
    "all null": [{"n": None}, {"n": None}],
    "int beside str": [{"m": 1}, {"m": "x"}],
    "bool beside int": [{"m": True}, {"m": 1}],
    "numpy float32 scalars": [{"f": np.float32(1.5)}, {"f": np.float32(2)}],
    "numpy int32 beside int": [{"i": np.int32(1)}, {"i": 5}],
    "nested lists": [{"l": [[1], [2, 3]]}],
    "empty lists": [{"e": []}, {"e": [None]}],
    "not dicts": [1, "two", 3.0],
    "large int": [{"big": 1 << 64}],
}


@pytest.mark.parametrize("name", sorted(ROW_CASES))
def test_block_from_rows_matches_the_jax_block(name):
    pytest.importorskip("pyarrow")
    from ray_tpu.data.block import BlockAccessor as JaxBlockAccessor

    rows = ROW_CASES[name]
    jblock = JaxBlockAccessor.build_from_rows(rows)
    pblock = BlockAccessor.build_from_rows(rows)
    assert isinstance(pblock, Table) == JaxBlockAccessor(jblock)._is_arrow()
    assert BlockAccessor(pblock).to_rows() == \
        JaxBlockAccessor(jblock).to_rows()
    assert BlockAccessor(pblock).num_rows() == \
        JaxBlockAccessor(jblock).num_rows()
    want = JaxBlockAccessor(jblock).to_batch()
    got = BlockAccessor(pblock).to_batch()
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert repr(want[k].tolist()) == repr(got[k].tolist()), k
    assert BlockAccessor(BlockAccessor(pblock).slice(1, 2)).to_rows() == \
        JaxBlockAccessor(JaxBlockAccessor(jblock).slice(1, 2)).to_rows()


BATCH_CASES = {
    "int32 and float32": {"a": np.arange(4, dtype=np.int32),
                          "b": np.linspace(0, 1, 4, dtype=np.float32)},
    "nan stays a value": {"f": np.array([1.5, np.nan])},
    "strings": {"s": np.array(["ab", "c"]), "o": np.array(["x", None],
                                                          dtype=object)},
    "2-d": {"m": np.ones((2, 3))},
    "bools and uint8": {"b": np.array([True, False]),
                        "u": np.array([1, 255], np.uint8)},
    # columns of two lengths: a list block of the first column's rows
    "ragged": {"a": np.arange(2), "b": np.arange(3)},
    "mixed objects": {"o": np.array([1, "x"], dtype=object)},
}


@pytest.mark.parametrize("name", sorted(BATCH_CASES))
def test_block_from_batch_matches_the_jax_block(name):
    pytest.importorskip("pyarrow")
    from ray_tpu.data.block import BlockAccessor as JaxBlockAccessor

    batch = BATCH_CASES[name]
    jblock = JaxBlockAccessor.build_from_batch(batch)
    pblock = BlockAccessor.build_from_batch(batch)
    assert isinstance(pblock, Table) == JaxBlockAccessor(jblock)._is_arrow()
    assert repr(BlockAccessor(pblock).to_rows()) == \
        repr(JaxBlockAccessor(jblock).to_rows())
    want = JaxBlockAccessor(jblock).to_batch()
    got = BlockAccessor(pblock).to_batch()
    assert list(want) == list(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert repr(want[k].tolist()) == repr(got[k].tolist()), k
