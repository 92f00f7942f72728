"""The port's ``multiprocessing.Pool`` shim: a mirror of
``tests/test_multiprocessing_pool.py`` on a port CPU cluster."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.multiprocessing import Pool


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _sq(x):
    return x * x


def _addmul(a, b, c=1):
    return (a + b) * c


def test_map_and_starmap(cluster):
    with Pool(processes=3) as pool:
        assert pool.map(_sq, range(8)) == [x * x for x in range(8)]
        assert pool.starmap(_addmul, [(1, 2), (3, 4)]) == [3, 7]


def test_apply_and_async(cluster):
    pool = Pool(processes=2)
    assert pool.apply(_addmul, (2, 3), {"c": 10}) == 50
    res = pool.apply_async(_sq, (9,))
    assert res.get(timeout=60) == 81
    assert res.ready()


def test_imap_unordered(cluster):
    pool = Pool(processes=3)
    out = sorted(pool.imap_unordered(_sq, range(6)))
    assert out == [x * x for x in range(6)]


def test_initializer(cluster):
    import os

    def init_env():
        os.environ["POOL_MARK"] = "yes"

    def read_env(_):
        import os

        return os.environ.get("POOL_MARK", "no")

    with Pool(processes=2, initializer=init_env) as pool:
        assert pool.map(read_env, [1, 2]) == ["yes", "yes"]
