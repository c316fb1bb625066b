"""Parity of the port's token pipeline (``repro_torch.data``) with the JAX
package's (``repro.data``).

Both are numpy: every batch is compared bit for bit (no tolerance), with
its dtype and shape, at several (seed, step, n_hosts, host_id), for
``SyntheticLM``, for ``MemmapTokens`` on a token file the test writes,
and through ``make_source``.
"""
import threading

import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro_torch import data as tdata

CASES = [(0, 0, 1, 0), (0, 7, 1, 0), (3, 2, 2, 1), (11, 5, 4, 0),
         (11, 5, 4, 3)]


def _same(got, want):
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,n_hosts,host", CASES)
def test_synthetic_batches_equal_jax(seed, step, n_hosts, host):
    kw = dict(vocab=512, seq_len=32, global_batch=8, seed=seed,
              n_hosts=n_hosts, host_id=host)
    got = tdata.SyntheticLM(**kw)(step)
    _same(got, jdata.SyntheticLM(**kw)(step))
    assert got["tokens"].shape == (8 // n_hosts, 32)
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["targets"][:, :-1])


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    rng = np.random.default_rng(5)
    rng.integers(0, 50_000, 20_000).astype(np.uint16).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed,step,n_hosts,host", CASES)
def test_memmap_batches_equal_jax(token_file, seed, step, n_hosts, host):
    kw = dict(seq_len=16, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_id=host)
    _same(tdata.MemmapTokens(token_file, **kw)(step),
          jdata.MemmapTokens(token_file, **kw)(step))


def test_memmap_hosts_take_disjoint_slices_of_one_draw(token_file):
    """The hosts' windows at a step are the single-host batch, split."""
    one = tdata.MemmapTokens(token_file, 16, 8, seed=2)(3)["tokens"]
    parts = [tdata.MemmapTokens(token_file, 16, 8, seed=2, n_hosts=4,
                                host_id=h)(3)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), one)


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_make_source_equals_jax(token_file, kind):
    kw = dict(seq_len=16, global_batch=4, seed=9)
    kw.update(vocab=1000) if kind == "synthetic" else kw.update(
        path=token_file)
    got, want = tdata.make_source(kind, **kw), jdata.make_source(kind, **kw)
    assert type(got).__name__ == type(want).__name__
    for step in (0, 1, 13):
        _same(got(step), want(step))


def test_bad_sizes_raise(token_file):
    with pytest.raises(ValueError, match="split"):
        tdata.SyntheticLM(512, 16, 6, n_hosts=4)
    with pytest.raises(ValueError, match="too small"):
        tdata.MemmapTokens(token_file, 4096, 8)


def test_prefetched_yields_the_steps_in_order():
    src = tdata.SyntheticLM(512, 8, 2, seed=4)
    before = set(threading.enumerate())
    it = tdata.prefetched(src, start_step=5, depth=2)
    for step in range(5, 12):
        _same(next(it), src(step))
    it.close()
    workers = set(threading.enumerate()) - before
    for t in workers:
        t.join(timeout=5)
        assert not t.is_alive()
