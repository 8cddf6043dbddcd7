"""repro_torch's data pipeline ≡ the reference's, bit for bit.

``batch_at`` is a copy of the reference's numpy module, its config taken
from the port's ``ModelConfig``: for every family that trains on the
card (dense, MoE, audio, VLM) and the SSM family, at several steps and
seeds, each array equals the reference's in dtype, shape and bits;
``stream`` yields ``batch_at`` step after step from its start.
"""
import itertools

import numpy as np
import pytest

from repro.configs.registry import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.models.common import reduce_config as j_reduce
from repro_torch.configs.registry import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.models.common import reduce_config

ARCHS = ("llama3-8b", "qwen2-moe-a2.7b", "hubert-xlarge", "internvl2-1b",
         "mamba2-780m")


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ARCHS + (None,))
@pytest.mark.parametrize("step", [0, 1, 17])
def test_batch_at_matches_reference(arch, step):
    jdc = jpipe.DataConfig(seed=3, seq_len=64, global_batch=4)
    tdc = tpipe.DataConfig(seed=3, seq_len=64, global_batch=4)
    jcfg = j_reduce(j_get_config(arch)) if arch else None
    tcfg = reduce_config(get_config(arch)) if arch else None
    _equal(jpipe.batch_at(jdc, step, jcfg), tpipe.batch_at(tdc, step, tcfg))


def test_full_config_batch_matches_reference():
    """llama3-8b's full vocabulary (128,256 tokens) at the phase-11 shape
    of one row."""
    jdc = jpipe.DataConfig(seq_len=4096, global_batch=1)
    tdc = tpipe.DataConfig(seq_len=4096, global_batch=1)
    _equal(jpipe.batch_at(jdc, 5, j_get_config("llama3-8b")),
           tpipe.batch_at(tdc, 5, get_config("llama3-8b")))


def test_stream_yields_batch_at_from_its_start():
    dc = tpipe.DataConfig(seed=1, seq_len=16, global_batch=2)
    cfg = reduce_config(get_config("internvl2-1b"))
    for i, b in enumerate(itertools.islice(tpipe.stream(dc, cfg, 3), 4)):
        _equal(b, tpipe.batch_at(dc, 3 + i, cfg))
        _equal(b, jpipe.batch_at(jpipe.DataConfig(seed=1, seq_len=16,
                                                  global_batch=2), 3 + i,
                                 j_reduce(j_get_config("internvl2-1b"))))


def test_data_pipeline_deterministic_and_shardable():
    """The reference's test, on the port."""
    dc = tpipe.DataConfig(seed=3, seq_len=64, global_batch=8)
    a = tpipe.batch_at(dc, 5)
    b = tpipe.batch_at(dc, 5)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = tpipe.batch_at(dc, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])
