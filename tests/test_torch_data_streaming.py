"""The port's streaming executor (``ray_tpu_torch/data/_internal``) on a port
cluster, on the CPU, against the JAX package's on a JAX cluster: a mirror
of ``tests/test_data_streaming.py`` (groupby, sort, join, zip, union, limit,
actor pools, writes and reads, stats), each pipeline built the same way on
both packages' data modules from the same seeded inputs. Rows are equal in
order where the JAX package keeps one (maps, filters, sort, zip, limit,
splits) and as multisets where its order depends on which task finished
first (shuffles, groupby partitions, joins, unions).

Every JAX-side call runs under a timeout. Nothing here imports JAX or the
JAX package at module level."""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as pdata

from test_torch_data import both, jax_side  # noqa: E402

T = 60


@pytest.fixture(scope="module")
def clusters():
    pytest.importorskip("pyarrow")  # the JAX package's blocks
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, device="cpu")
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _by(key):
    return lambda rows: sorted(rows, key=lambda r: repr(r[key]))


def test_groupby_aggregates(clusters):
    def build(rd):
        ds = rd.from_items([{"k": i % 3, "v": float(i)} for i in range(30)],
                           parallelism=4)
        return ds.groupby("k").aggregate(("count", None), ("sum", "v"),
                                         ("mean", "v"))

    want, got = both(build, lambda ds: _by("k")(ds.take_all()))
    assert got == want and len(got) == 3
    assert got[0]["count()"] == 10
    assert got[0]["sum(v)"] == sum(float(i) for i in range(30) if i % 3 == 0)
    assert got[1]["mean(v)"] == pytest.approx(
        np.mean([i for i in range(30) if i % 3 == 1]))
    # the single-aggregate shorthands
    for agg in ("count", "sum", "mean", "min", "max", "std"):
        def one(rd, agg=agg):
            grouped = rd.from_items(
                [{"k": i % 3, "v": float(i)} for i in range(30)],
                parallelism=4).groupby("k")
            return getattr(grouped, agg)(*(() if agg == "count" else ("v",)))

        want, got = both(one, lambda ds: _by("k")(ds.take_all()))
        assert got == want, agg


def test_groupby_min_max_std(clusters):
    def build(rd):
        ds = rd.from_items([{"k": "a", "v": float(i)} for i in range(5)]
                           + [{"k": "b", "v": 100.0}], parallelism=3)
        return ds.groupby("k").aggregate(("min", "v"), ("max", "v"),
                                         ("std", "v"))

    want, got = both(build, lambda ds: _by("k")(ds.take_all()))
    assert got == want
    assert got[0]["min(v)"] == 0.0 and got[0]["max(v)"] == 4.0
    assert got[0]["std(v)"] == pytest.approx(np.std(range(5), ddof=1))
    assert got[1]["std(v)"] == 0.0


def test_map_groups(clusters):
    def build(rd):
        ds = rd.from_items([{"k": i % 2, "v": i} for i in range(10)],
                           parallelism=3)
        return ds.groupby("k").map_groups(
            lambda members: [{"k": members[0]["k"],
                              "total": sum(m["v"] for m in members)}])

    want, got = both(build, lambda ds: _by("k")(ds.take_all()))
    assert got == want
    assert {r["k"]: r["total"] for r in got} == {0: 20, 1: 25}


def test_sort_global_order(clusters):
    rng = np.random.default_rng(0)
    vals = rng.permutation(200).tolist()

    def build(rd):
        return rd.from_items([{"v": v} for v in vals], parallelism=6)

    want, got = both(build, lambda ds: (
        [r["v"] for r in ds.sort("v").take_all()],
        [r["v"] for r in ds.sort("v", descending=True).take_all()],
        [r["v"] for r in ds.sort(lambda r: -r["v"]).take_all()]))
    assert got == want
    assert got[0] == sorted(vals) and got[1] == sorted(vals, reverse=True)


def test_join_inner_and_left(clusters):
    def build(rd):
        left = rd.from_items([{"id": i, "a": i * 10} for i in range(8)],
                             parallelism=3)
        right = rd.from_items([{"id": i, "b": i * 100}
                               for i in range(4, 12)], parallelism=3)
        return left, right

    # A join partition's block takes its columns from its first row (arrow's
    # from_pylist; the port's Table does the same), and the rows come in
    # the order the reduce takes the map outputs. The JAX join takes them
    # in the order its maps finish, so under load a left or outer join
    # keeps or drops the right side's columns by timing; the port's takes
    # them in input order. One JAX task at a time makes the JAX maps finish
    # in input order too.
    import ray_tpu.data as jdata

    jctx = jdata.DataContext.get_current()
    prev = jctx.max_tasks_in_flight
    jctx.max_tasks_in_flight = 1
    try:
        for how in ("inner", "left", "right", "outer"):
            want, got = both(build, lambda lr: _by("id")(
                lr[0].join(lr[1], on="id", how=how).take_all()))
            assert sorted(map(repr, got)) == sorted(map(repr, want)), how
    finally:
        jctx.max_tasks_in_flight = prev
    inner = both(build, lambda lr: lr[0].join(lr[1], on="id").take_all())[1]
    assert sorted(r["id"] for r in inner) == [4, 5, 6, 7]
    assert all(r["b"] == r["id"] * 100 and r["a"] == r["id"] * 10
               for r in inner)


def test_join_reduce_takes_map_outputs_in_input_order():
    """The port's join hands its reduce each side's map outputs in input
    order whatever order the maps finish in, so a left or outer join's
    columns do not depend on timing."""
    from ray_tpu_torch.data.dataset import _JoinOperator
    from ray_tpu_torch.data._internal.operators import RefBundle

    op = _JoinOperator("id", "left", "_right", None)
    left = [RefBundle(f"l{i}") for i in range(3)]
    right = [RefBundle(f"r{i}") for i in range(2)]
    for b in left:
        op.add_left(b)
    for b in right:
        op.add_right(b)
    op.inputs_done = True
    op._advance_phase()
    assert op._phase == "map"
    for b in [right[1], left[2], left[0], right[0], left[1]]:  # finish order
        op._on_map_done(f"map:{b.block}", b)
    op._on_all_maps_done()
    assert op._left_map_count == 3
    assert op._map_outputs == ["map:l0", "map:l1", "map:l2", "map:r0",
                               "map:r1"]


def test_zip_and_union(clusters):
    def build(rd):
        a = rd.from_items([{"x": i} for i in range(10)], parallelism=2)
        b = rd.from_items([{"y": i * 2} for i in range(10)], parallelism=2)
        return a, b

    want, got = both(build, lambda ab: (
        ab[0].zip(ab[1]).take_all(), ab[0].union(ab[1]).count(),
        sorted(map(repr, ab[0].union(ab[1]).take_all()))))
    assert got == want
    assert all(r["y"] == r["x"] * 2 for r in got[0]) and got[1] == 20


def test_limit_early_stop(clusters):
    want, got = both(lambda rd: rd.range(100000, parallelism=64).limit(5))
    assert got == want == [{"id": i} for i in range(5)]


def test_map_batches_class_udf_actor_pool(clusters):
    class AddBias:
        def __init__(self, bias):
            self.bias = bias
            self.calls = 0

        def __call__(self, batch):
            self.calls += 1
            return {"id": batch["id"], "b": batch["id"] + self.bias}

    want, got = both(lambda rd: rd.range(64, parallelism=4).map_batches(
        AddBias, fn_constructor_args=(100,), concurrency=2))
    assert got == want and len(got) == 64
    assert all(r["b"] == r["id"] + 100 for r in got)


def test_fused_chain_order_preserved(clusters):
    def build(rd):
        return (rd.range(100, parallelism=8)
                .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
                .filter(lambda r: r["id"] % 2 == 0)
                .map(lambda r: {"sq": r["sq"]}))

    want, got = both(build)
    assert got == want
    assert [r["sq"] for r in got] == [i ** 2 for i in range(100) if i % 2 == 0]


def test_count_does_not_fetch(clusters):
    want, got = both(lambda rd: rd.range(5000, parallelism=10),
                     lambda ds: ds.count())
    assert got == want == 5000


def test_random_shuffle(clusters):
    want, got = both(lambda rd: rd.range(300, parallelism=4).random_shuffle(
        seed=7), lambda ds: [r["id"] for r in ds.take_all()])
    assert sorted(got) == sorted(want) == list(range(300))
    assert got != list(range(300))


def test_repartition(clusters):
    want, got = both(lambda rd: rd.range(100, parallelism=2).repartition(
        8).materialize(), lambda ds: (ds.num_blocks(), ds.count(), sorted(
            r["id"] for r in ds.take_all())))
    assert got == want == (8, 100, list(range(100)))


def test_write_and_read_roundtrips(clusters, tmp_path):
    """Each package writes parquet, CSV and JSON lines; each reads what
    either wrote, to the same rows."""
    import ray_tpu.data as jdata

    def build(rd):
        return rd.from_items([{"a": i, "b": f"s{i}", "c": i / 4,
                               "d": i % 2 == 0} for i in range(20)],
                             parallelism=3)

    want = build(pdata).take_all()
    for fmt in ("parquet", "csv", "json"):
        jpaths = jax_side(lambda: getattr(build(jdata), "write_" + fmt)(
            str(tmp_path / ("j" + fmt))))
        ppaths = getattr(build(pdata), "write_" + fmt)(
            str(tmp_path / ("p" + fmt)))
        assert len(jpaths) == len(ppaths) == 3, fmt
        for src in ("j", "p"):
            path = str(tmp_path / (src + fmt))
            got_j = jax_side(lambda: getattr(jdata, "read_" + fmt)(
                path).take_all())
            got_p = getattr(pdata, "read_" + fmt)(path).take_all()
            assert got_p == got_j == want, (fmt, src)


def test_read_text(clusters, tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    want, got = both(lambda rd: rd.read_text(str(p)))
    assert got == want
    assert [r["text"] for r in got] == ["alpha", "beta", "gamma"]
    want, got = both(lambda rd: rd.read_binary_files(str(p)))
    assert got == want and got[0]["bytes"] == b"alpha\nbeta\ngamma\n"


def test_stats_populated(clusters):
    def run(ds):
        ds.take_all()
        return [line.split(":")[0] for line in ds.stats().splitlines()]

    want, got = both(lambda rd: rd.range(100, parallelism=4).map(lambda r: r),
                     run)
    assert got == want
    s = "\n".join(got)
    assert "Read" in s and "Map" in s


def test_train_test_split(clusters):
    want, got = both(lambda rd: rd.range(100, parallelism=4),
                     lambda ds: [p.take_all() for p in
                                 ds.train_test_split(0.2)])
    assert got == want
    assert [len(p) for p in got] == [80, 20]


def test_empty_dataset_through_shuffle(clusters):
    want, got = both(lambda rd: rd.from_items([{"v": 1}]).filter(
        lambda r: False), lambda ds: (ds.random_shuffle().count(),
                                      ds.sort("v").take_all()))
    assert got == want == (0, [])


def test_schema_abandons_stream_cleanly(clusters):
    ds = pdata.range(10000, parallelism=32)
    schema = ds.schema()  # early abandon must not deadlock
    assert schema.names == ["id"] and schema.types == ["int64"]
    assert ds.count() == 10000  # and the dataset is still consumable
    import ray_tpu.data as jdata

    jschema = jax_side(lambda: jdata.range(10000, parallelism=32).schema())
    assert jschema.names == schema.names
    assert [str(t) for t in jschema.types] == schema.types


def test_zip_mismatched_parallelism(clusters):
    def build(rd):
        a = rd.from_items([{"x": i} for i in range(10)], parallelism=2)
        b = rd.from_items([{"y": i * 3} for i in range(10)], parallelism=5)
        return a.zip(b)

    want, got = both(build)
    assert got == want and len(got) == 10
    assert all(r["y"] == r["x"] * 3 for r in got)


def test_zip_unequal_rows_raises(clusters):
    a = pdata.from_items([{"x": i} for i in range(5)])
    b = pdata.from_items([{"y": i} for i in range(6)])
    with pytest.raises(Exception, match="equal row counts"):
        a.zip(b).take_all()


def test_materialized_parent_not_reexecuted(clusters, tmp_path):
    marker = str(tmp_path / "marker")

    def touch(r, marker=marker):
        with open(marker, "a") as f:
            f.write("x")
        return r

    ds = pdata.range(4, parallelism=1).map(touch).materialize()
    runs1 = os.path.getsize(marker)
    assert ds.take(2) and ds.count() == 4  # derived ops reuse the cache
    assert os.path.getsize(marker) == runs1


def test_groupby_minmax_strings(clusters):
    want, got = both(lambda rd: rd.from_items(
        [{"k": 1, "name": n} for n in ["bob", "alice", "carol"]]).groupby(
        "k").aggregate(("min", "name"), ("max", "name")))
    assert got == want
    assert got[0]["min(name)"] == "alice" and got[0]["max(name)"] == "carol"


def test_repartition_balances_tiny_blocks(clusters):
    # 40 one-row blocks -> 4 partitions: no partition may hog everything
    ds = pdata.from_items([{"v": i} for i in range(40)],
                          parallelism=40).repartition(4).materialize()
    assert ds.count() == 40
    sizes = [b.rows for b in ds._materialized]
    assert len(sizes) == 4 and max(sizes) < 40


def test_pipeline_soak_no_row_loss(clusters):
    """Repeated multi-stage pipelines must never drop rows (the executor
    raises on undrained operators at termination)."""
    def build(rd):
        orders = rd.from_items(
            [{"u": f"u{i % 5}", "v": float(i)} for i in range(200)],
            parallelism=8)
        totals = orders.groupby("u").sum("v")
        users = rd.from_items([{"u": f"u{i}", "t": i} for i in range(5)])
        return totals.join(users, on="u").sort("sum(v)", descending=True)

    for trial in range(3):
        want, got = both(build)
        assert got == want, f"trial {trial}"
        assert [r["u"] for r in got] == ["u4", "u3", "u2", "u1", "u0"]
