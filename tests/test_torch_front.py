"""The chain front: the port's front_chain (plain version on the CPU, the
CUDA kernel on the card) against the JAX Pallas kernel in interpret mode
and its XLA mirror, at the JAX front-kernel budget rtol 2e-5, atol 1e-6
(test_pallas_multiband.py:160)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from python_audio_mastering_tpu.ops import pallas_multiband as pmb
from python_audio_mastering_tpu_torch import ChainConfig, MasteringChain, MasteringParams
from python_audio_mastering_tpu_torch.ops import cuda_multiband as cmb
from python_audio_mastering_tpu_torch.ops import iir
from python_audio_mastering_tpu_torch.ops.waveshaper import saturate

from .conftest import make_signal

FS = 44100
L = 384
SETTINGS = {"saturation": 25, "preset": "dubstep", "width": 1.4}



def _operands(channels, nb=48, seed=0, device="cpu"):
    params = MasteringParams.from_settings(SETTINGS)
    chain = MasteringChain(ChainConfig.gpu_default(FS)).to(device)
    x = (make_signal(nb * L, channels=channels, seed=seed) * 0.5).T
    xrows = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                            device=device).reshape(channels, nb, L)
    ops = chain.eq_ops(params)
    s_in, _, _ = iir.sosfilt_states_rows(
        None, saturate(xrows, params.saturation), ops=ops)
    return params, xrows, s_in, ops


@pytest.mark.parametrize("emit_mono", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_front_chain_ref_matches_jax(channels, emit_mono):
    params, xrows, s_in, ops = _operands(channels, seed=channels)
    emit = emit_mono and channels > 1
    got = cmb.front_chain(xrows, s_in, ops.t, ops.w, params.saturation,
                          params.width, emit_mono=emit)
    args = [jnp.asarray(a.numpy()) for a in (xrows, s_in, ops.t, ops.w)]
    refs = (pmb.front_chain(*args, params.saturation, params.width,
                            emit_mono=emit, interpret=True),
            pmb.front_chain_xla(*args, params.saturation, params.width,
                                emit_mono=emit))
    got = got if emit else (got,)
    for ref in refs:
        ref = ref if emit else (ref,)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                       atol=1e-6)


def test_front_two_chunks_equal_one_shot():
    """Two chunks with the EQ state carried equal one pass (rows form)."""
    params = MasteringParams.from_settings(SETTINGS)
    chain = MasteringChain(ChainConfig.gpu_default(FS))
    nb = 48
    x = (make_signal(nb * L, channels=2, seed=4) * 0.5).T
    xrows = torch.as_tensor(np.ascontiguousarray(x, np.float32)).reshape(
        2, nb, L)
    one, ym_one = chain.front(xrows, params, emit_mono=True)
    half = nb // 2
    y1, m1, zf = chain.front(xrows[:, :half].contiguous(), params,
                             return_state=True, emit_mono=True)
    y2, m2 = chain.front(xrows[:, half:].contiguous(), params, state=zf,
                         emit_mono=True)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(),
                               one.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([m1, m2], dim=0).numpy(),
                               ym_one.numpy(), rtol=2e-5, atol=1e-6)
