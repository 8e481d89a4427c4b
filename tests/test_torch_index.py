"""tpu_rvc_torch's index build (minibatch k-means, build_index, save and
load) against tpu_rvc's on the CPU: same seeded features, same numpy
draws, so the same batches in the same order."""

import numpy as np
import pytest
import torch

from tpu_rvc.retrieval import index as jax_index

from tpu_rvc_torch.retrieval import index as port_index
from tpu_rvc_torch.retrieval.index import (FeatureIndex, build_index,
                                           train_kmeans)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def features(n=2000, d=32, seed=0):
    """Clustered rows, so that assignments are not near-ties."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((40, d)) * 4
    return (centres[rng.integers(0, 40, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("k,iters,batch,seed", [(64, 3, 512, 0),
                                                (50, 2, 300, 5)])
def test_train_kmeans_matches_jax(k, iters, batch, seed):
    """Centroids rtol 1e-4 on a seeded 2,000 x 32 set; the second case has
    a ragged last batch."""
    x = features()
    want = jax_index.train_kmeans(x, k, iters, batch, seed)
    got = train_kmeans(x, k, iters, batch, seed, device="cpu")
    assert got.shape == (k, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # it moved away from its initial rows towards cluster means
    init = x[np.random.default_rng(seed).choice(len(x), k, replace=False)]
    assert np.abs(got - init).max() > 0.05


def test_build_index_below_and_above_threshold(monkeypatch):
    x = features(600, 16, seed=1)
    flat = build_index(x, "v2", device="cpu")
    assert not flat.kmeans_compressed and flat.dim == 16
    np.testing.assert_array_equal(flat.vectors, x)
    np.testing.assert_allclose(flat.norms_sq, (x * x).sum(1), rtol=1e-6)

    monkeypatch.setattr(port_index, "KMEANS_CLUSTERS", 32)
    monkeypatch.setattr(jax_index, "KMEANS_CLUSTERS", 32)
    small = build_index(x, "v1", kmeans_threshold=500, seed=3, device="cpu")
    want = jax_index.build_index(x, "v1", kmeans_threshold=500, seed=3)
    assert small.kmeans_compressed and small.version == "v1"
    assert small.vectors.shape == (32, 16)
    np.testing.assert_allclose(small.vectors, want.vectors, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(small.norms_sq, want.norms_sq, rtol=1e-4)


def test_index_save_load_round_trip_and_interchange(tmp_path):
    """The port's `.npz` reads back, and each package reads the other's."""
    x = features(100, 8, seed=2)
    idx = FeatureIndex(x, (x * x).sum(1), "v1", True)
    path = str(tmp_path / "voice.tpuidx")
    idx.save(path, write_big_npy=True)
    for loaded in (FeatureIndex.load(path), FeatureIndex.load(path + ".npz"),
                   jax_index.FeatureIndex.load(path)):
        np.testing.assert_array_equal(loaded.vectors, x)
        np.testing.assert_array_equal(loaded.norms_sq, idx.norms_sq)
        assert loaded.version == "v1" and loaded.kmeans_compressed is True
    big = FeatureIndex.load(str(tmp_path / "voice_total_fea.npy"))
    np.testing.assert_array_equal(big.vectors, x)
    jpath = str(tmp_path / "jax.npz")
    jax_index.FeatureIndex(x, idx.norms_sq).save(jpath)
    back = FeatureIndex.load(jpath)
    assert back.version == "v2" and not back.kmeans_compressed
    vecs, sq = back.device_arrays("cpu")
    assert vecs.dtype == torch.float32 and tuple(sq.shape) == (100,)
    assert back.device_arrays("cpu")[0] is vecs  # uploaded once


def test_train_kmeans_device_rule():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_kmeans(features(100, 4), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index(features(100, 4), kmeans_threshold=10)
