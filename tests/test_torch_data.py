"""Port parity for the data pipeline: the port's SyntheticStream and
FileStream give the reference's batches bit for bit."""
import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro_torch.data import pipeline as tdata


@pytest.mark.parametrize("seed,step,host,n_hosts", [
    (0, 0, 0, 1), (0, 50_000, 0, 1), (7, 12, 1, 2), (3, 100_000, 2, 4)])
def test_synthetic_stream_equal(seed, step, host, n_hosts):
    kw = dict(seed=seed, host_id=host, n_hosts=n_hosts)
    want = jdata.SyntheticStream(512, 4, 40, **kw).batch_at(step)["tokens"]
    got = tdata.SyntheticStream(512, 4, 40, **kw).batch_at(step)["tokens"]
    assert got.dtype == want.dtype and got.shape == (4, 41)
    np.testing.assert_array_equal(got, want)


def test_synthetic_stream_iter_equal():
    j = iter(jdata.SyntheticStream(64, 2, 8, seed=1))
    t = iter(tdata.SyntheticStream(64, 2, 8, seed=1))
    for _ in range(3):
        np.testing.assert_array_equal(next(t)["tokens"], next(j)["tokens"])


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_file_stream_equal(tmp_path, host, n_hosts):
    path = str(tmp_path / "tokens.bin")
    tdata.write_token_file(path, np.random.default_rng(0).integers(
        0, 1000, 12 * 17))
    jpath = str(tmp_path / "ref.bin")
    jdata.write_token_file(jpath, np.random.default_rng(0).integers(
        0, 1000, 12 * 17))
    assert open(path, "rb").read() == open(jpath, "rb").read()
    kw = dict(vocab_size=700, batch=4, seq=16, seed=3, host_id=host,
              n_hosts=n_hosts)
    jfs, tfs = jdata.FileStream(jpath, **kw), tdata.FileStream(path, **kw)
    for step in range(4):                      # crosses an epoch boundary
        np.testing.assert_array_equal(tfs.batch_at(step)["tokens"],
                                      jfs.batch_at(step)["tokens"])
    it = tfs.prefetching_iter(2)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jfs.batch_at(2)["tokens"])
