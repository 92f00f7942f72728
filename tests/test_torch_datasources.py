"""TFRecord / WebDataset / SQL / HuggingFace datasources of the port
(``ray_tpu_torch/data/datasources.py``) on a port cluster, on the CPU,
against the JAX package's on a JAX cluster: a mirror of
``tests/test_datasources.py``. The ``tf.train.Example`` codec gives the JAX
codec's bytes; a TFRecord or WebDataset file written by one package reads
back in the other to the same rows; SQL reads equal.

Every JAX-side call runs under a timeout. Nothing here imports JAX or the
JAX package at module level."""

import sqlite3

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as pdata
from ray_tpu_torch.data import datasources as pds

from test_torch_data import both  # noqa: E402


@pytest.fixture(scope="module")
def clusters():
    pytest.importorskip("pyarrow")  # the JAX package's blocks
    import ray_tpu

    ray_tpu.shutdown()
    ray_tpu.init(resources={"CPU": 4.0})
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


ROWS = [{"label": 3, "weights": [0.5, 1.5], "name": b"cat",
         "ids": [1, 2, 300000]},
        {"neg": -7, "f": 2.25, "s": "text", "many": [b"a", b"bc"]},
        {"arr": np.arange(3), "farr": np.array([0.25, -1.0], np.float32)}]


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_example_proto_roundtrip(i):
    from ray_tpu.data import datasources as jds

    row = ROWS[i]
    blob = pds.encode_example(row)
    assert blob == jds.encode_example(row)
    out = pds.decode_example(blob)
    assert repr(out) == repr(jds.decode_example(blob))
    if i == 0:
        assert out["label"] == 3
        assert out["ids"] == [1, 2, 300000]
        assert out["name"] == b"cat"
        assert out["weights"] == pytest.approx([0.5, 1.5])
    assert pds._masked_crc(blob) == jds._masked_crc(blob)


def test_read_tfrecords(clusters, tmp_path):
    """Each package writes TFRecord files; each reads what either wrote."""
    from ray_tpu.data import datasources as jds

    rows = [{"i": i, "x": float(i) / 2, "tag": f"r{i}".encode()}
            for i in range(20)]
    pds.write_tfrecords(rows[:10], str(tmp_path / "a.tfrecords"))
    jds.write_tfrecords(rows[10:], str(tmp_path / "b.tfrecords"))
    assert (tmp_path / "a.tfrecords").read_bytes() == _jax_tfrecord(
        jds, rows[:10], tmp_path / "a_jax.tfrecords")
    want, got = both(lambda rd: rd.read_tfrecords(str(tmp_path / "a.tfrecords"))
                     .union(rd.read_tfrecords(str(tmp_path / "b.tfrecords"))),
                     lambda ds: sorted(ds.take_all(), key=lambda r: r["i"]))
    assert got == want and len(got) == 20
    assert got[5]["tag"] == b"r5"
    assert got[7]["x"] == pytest.approx(3.5)


def _jax_tfrecord(jds, rows, path):
    jds.write_tfrecords(rows, str(path))
    return path.read_bytes()


@pytest.mark.skipif(
    __import__("importlib").util.find_spec("tensorflow") is None,
    reason="tensorflow not in image")
def test_tfrecords_tensorflow_compat(tmp_path):
    import tensorflow as tf

    pds.write_tfrecords([{"v": 7}], str(tmp_path / "c.tfrecords"))
    recs = list(tf.data.TFRecordDataset(str(tmp_path / "c.tfrecords")))
    ex = tf.train.Example.FromString(recs[0].numpy())
    assert ex.features.feature["v"].int64_list.value[0] == 7


def test_read_webdataset(clusters, tmp_path):
    """Each package writes a shard; each reads both shards."""
    from ray_tpu.data import datasources as jds

    rows = [{"__key__": f"s{i:03d}", "txt": f"caption {i}",
             "bin": bytes([i] * 4)} for i in range(6)]
    pds.write_webdataset(rows[:3], str(tmp_path / "shard0.tar"))
    jds.write_webdataset(rows[3:], str(tmp_path / "shard1.tar"))
    want, got = both(lambda rd: rd.read_webdataset(str(tmp_path)),
                     lambda ds: sorted(ds.take_all(),
                                       key=lambda r: r["__key__"]))
    assert got == want and len(got) == 6
    assert got[2]["txt"] == "caption 2"
    assert got[4]["bin"] == bytes([4] * 4)


def test_read_sql(clusters, tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE pets (name TEXT, age INT, w REAL)")
    conn.executemany("INSERT INTO pets VALUES (?, ?, ?)",
                     [("rex", 3, 9.5), ("ada", 7, None), ("bo", 1, 2.0)])
    conn.commit()
    conn.close()
    want, got = both(lambda rd: rd.read_sql(
        "SELECT name, age, w FROM pets WHERE age > 2",
        lambda: sqlite3.connect(db)),
        lambda ds: sorted(ds.take_all(), key=lambda r: r["name"]))
    assert got == want == [{"name": "ada", "age": 7, "w": None},
                           {"name": "rex", "age": 3, "w": 9.5}]


def test_from_huggingface(clusters):
    datasets = pytest.importorskip("datasets")
    hf = datasets.Dataset.from_dict(
        {"text": [f"t{i}" for i in range(8)], "label": list(range(8))})
    want, got = both(lambda rd: rd.from_huggingface(hf),
                     lambda ds: sorted(ds.take_all(), key=lambda r: r["label"]))
    assert got == want and len(got) == 8 and got[3]["text"] == "t3"


def test_from_huggingface_rows_without_arrow(clusters):
    """A dataset without an arrow table: its rows."""
    class Rows:
        def __iter__(self):
            return iter([{"text": f"t{i}", "label": i} for i in range(5)])

    want, got = both(lambda rd: rd.from_huggingface(Rows()),
                     lambda ds: ds.take_all())
    assert got == want and len(got) == 5
    assert isinstance(pdata.from_huggingface(Rows()), pdata.Dataset)
