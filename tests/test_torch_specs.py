"""The dry run's input specs against the reference's: the counterparts of
``tests/test_system.py::test_input_specs_shapes`` and
``::test_decode_specs_build_without_allocation``.

The port's specs are tensors on the ``meta`` device (a shape and a dtype,
nothing allocated) where the reference's are ``ShapeDtypeStruct``s; token
ids are int64 (the port's batches) where the reference's are int32.  The
decode caches are the port's per layer, batch first; the reference stacks
each unit position's caches over its repeats, so layer l is the reference's
position l mod U, repeat l // U, and its shape is the reference's less the
leading repeats axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import specs as ref_specs
from repro.configs.reduce import make_reduced as ref_make_reduced
from repro_torch.configs import base
from repro_torch.configs import specs
from repro_torch.configs.reduce import make_reduced
from repro_torch.models.stack import find_unit

CASES = [("yi-6b", "train_4k"), ("musicgen-large", "prefill_32k"), ("qwen2-vl-72b", "train_4k"),
         ("h2o-danube-1.8b", "prefill_32k")]


def _dtype(ref_dtype) -> torch.dtype:
    """The port's dtype for a reference input dtype (int32 ids → int64)."""
    if ref_dtype == jnp.int32:
        return torch.int64
    return getattr(torch, jnp.dtype(ref_dtype).name)


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_shapes(arch, shape):
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    sp = specs.input_specs(cfg, base.LM_SHAPES[shape])
    ref = ref_specs.input_specs(ref_cfg, ref_base.LM_SHAPES[shape])
    assert sorted(sp) == sorted(ref)
    for k, v in sp.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert v.dtype == _dtype(ref[k].dtype), k
    # the reference test's own numbers
    if arch == "yi-6b":
        assert tuple(sp["tokens"].shape) == (256, 4096) and sp["targets"].dtype == torch.int64
    if arch == "musicgen-large":
        assert tuple(sp["frame_embeds"].shape) == (32, 32768, 2048)
    if arch == "qwen2-vl-72b":
        assert tuple(sp["mrope_positions"].shape) == (256, 3, 4096) and sp["vision_embeds"].shape[1] == 1024


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m", "h2o-danube-1.8b", "qwen2-vl-72b"])
def test_decode_specs_build_without_allocation(arch):
    cfg, ref_cfg = make_reduced(base.get_config(arch)), ref_make_reduced(ref_base.get_config(arch))
    shape = base.LM_SHAPES["decode_32k"]
    tok, caches, t = specs.decode_state_specs(cfg, shape)
    ref_tok, ref_caches, ref_t = ref_specs.decode_state_specs(ref_cfg, ref_base.LM_SHAPES["decode_32k"])
    assert tuple(tok.shape) == tuple(ref_tok.shape) == (128,) and tok.dtype == torch.int64
    assert tuple(t.shape) == () and t.device.type == "meta"
    pattern = cfg.pattern()
    unit = len(find_unit(pattern))
    assert len(caches) == len(pattern) and len(ref_caches) == unit
    for layer, cache in enumerate(caches):
        ref = ref_caches[layer % unit]
        assert type(cache).__name__ == type(ref).__name__
        for name, v in cache._asdict().items():
            r = getattr(ref, name)
            if v is None:  # no int8 scales
                assert r is None, (layer, name)
                continue
            if not torch.is_tensor(v):  # a position counter: the reference's (R,) leaf
                assert v == 0 and r.shape == (len(pattern) // unit,), (layer, name)
                continue
            # every tensor lives on the meta device: nothing allocated
            assert v.device.type == "meta", (layer, name)
            assert tuple(v.shape) == tuple(r.shape[1:]), (layer, name)
            assert v.dtype == _dtype(r.dtype), (layer, name)
    assert all(isinstance(leaf, jax.ShapeDtypeStruct) for leaf in jax.tree.leaves(ref_caches))
    assert np.prod(tok.shape) == 128
