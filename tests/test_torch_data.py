"""The port's synthetic data pipeline against the JAX package's: the same
numpy arrays bit for bit, for every architecture's smoke config (token,
``frames`` and ``patches`` batches), at two steps and two seeds, and the
same shards and prefetched batches from ``SyntheticPipeline``.

Both pipelines are numpy only; the reference module is imported through
the JAX package, which the machine with the card does not have: there this
module skips as a whole."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe

B, S = 4, 24


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_synthetic_batch_bit_equal(arch, seed):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    seq = S + (jcfg.n_patches if jcfg.frontend == "vision_stub" else 0)
    for step in (0, 3):
        want = jpipe.synthetic_batch(jcfg, B, seq, step=step,
                                     dc=jpipe.DataConfig(seed=seed))
        got = tpipe.synthetic_batch(tcfg, B, seq, step=step,
                                    dc=tpipe.DataConfig(seed=seed))
        _equal(got, want)
    key = {"audio_stub": "frames", "vision_stub": "patches"}.get(
        tcfg.frontend, "tokens")
    assert key in got


def test_batches_differ_by_step_and_seed():
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    a = tpipe.synthetic_batch(cfg, B, S)["tokens"]
    assert not np.array_equal(a, tpipe.synthetic_batch(
        cfg, B, S, step=1)["tokens"])
    assert not np.array_equal(a, tpipe.synthetic_batch(
        cfg, B, S, dc=tpipe.DataConfig(seed=1))["tokens"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge",
                                  "internvl2-2b"])
def test_pipeline_shards_and_prefetch_equal_jax(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    seq = S + (jcfg.n_patches if jcfg.frontend == "vision_stub" else 0)
    for host in range(2):
        want = jpipe.SyntheticPipeline(jcfg, B, seq, host_index=host,
                                       host_count=2)
        got = tpipe.SyntheticPipeline(tcfg, B, seq, host_index=host,
                                      host_count=2)
        for step in (0, 1, 2, 5):
            _equal(got.get(step), want.get(step))
        # steps 1 and 2 came from the prefetch: each is popped once
        assert sorted(got._cache) == sorted(want._cache)
    # the two hosts' shards make up the whole batch, in host order
    full = tpipe.synthetic_batch(tcfg, B, seq, step=4)
    shards = [tpipe.SyntheticPipeline(tcfg, B, seq, host_index=h,
                                      host_count=2).get(4) for h in range(2)]
    _equal({k: np.concatenate([s[k] for s in shards]) for k in full}, full)
