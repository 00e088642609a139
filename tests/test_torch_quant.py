"""The port's serving quantizers, policy, configs and plain quantized
matmuls against the JAX reference, on the same seeded numpy inputs.

Integer results are compared bit for bit.  The port's W4A8 plain version
sums exactly (in float64, cast to int32) where the reference sums in
float32, so there the bound is ``rtol = atol = 1e-5``, the bound
``tests/test_kernels.py`` holds the Pallas kernel to.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as R_configs
from repro.configs import base as R_base
from repro.kernels import ops as R_ops
from repro.quant import policy as R_policy
from repro.quant import qlinear as R_ql
from repro.quant import quantizers as R_qz
from repro_torch import configs as T_configs
from repro_torch.configs import base as T_base
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels import w8a8_matmul as T_w8a8
from repro_torch.quant import policy as T_policy
from repro_torch.quant import qlinear as T_ql
from repro_torch.quant import quantizers as T_qz

W8A8_SHAPES = [(32, 32, 32), (64, 96, 48), (33, 70, 17), (128, 64, 96)]
W4A8_SHAPES = [(32, 32, 32), (64, 128, 48), (16, 64, 96)]


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _operands(m, k, n, seed, pow2: bool):
    """Quantized operands, made by the reference and handed to both."""
    x = jnp.asarray(_normal(seed, (m, k)))
    w = jnp.asarray(_normal(seed + 1, (k, n)))
    xs = R_qz.int_scale(x, 8)
    xq = R_qz.quantize_int(x, xs, 8)
    if pow2:
        ws = R_qz.pow2_scale(w, axis=0)
        wq = R_qz.pack_int4(R_qz.pow2_encode(w, ws).T).T
    else:
        ws = R_qz.int_scale(w, 8, axis=0)
        wq = R_qz.quantize_int(w, ws, 8)
    jax_ops = (xq, wq, xs, ws)
    return jax_ops, tuple(torch.from_numpy(np.array(a)) for a in jax_ops)


# --------------------------------------------------------------- quantizers

@pytest.mark.parametrize("shape,axis", [((64, 96), None), ((64, 96), 0),
                                        ((384, 128), None), ((384, 128), 0),
                                        ((7,), None)])
def test_int_quantizers_bit_identical(shape, axis):
    xj, xt = _both(_normal(0, shape) * 3.0)
    sj, st = R_qz.int_scale(xj, 8, axis=axis), T_qz.int_scale(xt, 8,
                                                              axis=axis)
    _eq(sj, st)
    qj, qt = R_qz.quantize_int(xj, sj, 8), T_qz.quantize_int(xt, st, 8)
    assert qt.dtype == torch.int8
    _eq(qj, qt)
    _eq(R_qz.dequantize_int(qj, sj), T_qz.dequantize_int(qt, st))
    _eq(R_qz.quantize_int(xj, sj, 16), T_qz.quantize_int(xt, st, 16))


@pytest.mark.parametrize("shape", [(64, 96), (128, 40)])
def test_pow2_quantizers_bit_identical(shape):
    wj, wt = _both(_normal(1, shape))
    sj, st = R_qz.pow2_scale(wj, axis=0), T_qz.pow2_scale(wt, axis=0)
    _eq(sj, st)
    cj, ct = R_qz.pow2_encode(wj, sj), T_qz.pow2_encode(wt, st)
    assert ct.dtype == torch.int8
    _eq(cj, ct)
    _eq(R_qz.pow2_decode(cj, sj), T_qz.pow2_decode(ct, st))
    assert T_qz.POW2_EXP_BIAS == R_qz.POW2_EXP_BIAS


def test_pack_unpack_int4_bit_identical():
    codes = np.random.default_rng(2).integers(0, 16, (6, 10, 24)) \
        .astype(np.int8)
    cj, ct = _both(codes)
    pj, pt = R_qz.pack_int4(cj), T_qz.pack_int4(ct)
    assert pt.dtype == torch.int8 and tuple(pt.shape) == (6, 10, 12)
    _eq(pj, pt)
    _eq(R_qz.unpack_int4(pj), T_qz.unpack_int4(pt))
    with pytest.raises(ValueError, match="even"):
        T_qz.pack_int4(ct[..., :3])


@pytest.mark.parametrize("mode", ["w8a8", "w4a8_pow2"])
def test_quantize_weight_bit_identical(mode):
    w = _normal(3, (96, 40))
    qj = R_ql.quantize_weight(jnp.asarray(w), R_policy.policy_for(mode))
    qt = T_ql.quantize_weight(torch.from_numpy(w), T_policy.policy_for(mode))
    assert qt.mode == qj.mode and qt.orig_shape == tuple(qj.orig_shape)
    _eq(qj.data, qt.data)
    _eq(qj.scale, qt.scale)
    _eq(R_ql.dequantize_weight(qj), T_ql.dequantize_weight(qt))
    with pytest.raises(ValueError, match="not a quantized mode"):
        T_ql.quantize_weight(torch.from_numpy(w), T_policy.policy_for("bf16"))


# ------------------------------------------------------- plain matmuls

@pytest.mark.parametrize("m,k,n", W8A8_SHAPES)
def test_w8a8_plain_equals_reference(m, k, n):
    j, t = _operands(m, k, n, seed=10 + m, pow2=False)
    got = T_ops.w8a8_matmul(*t, impl="ref")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    _eq(R_ops.w8a8_matmul(*j, impl="ref"), got)
    _eq(R_ops.w8a8_matmul(*j, impl="interpret", bm=32, bn=32, bk=32), got)
    np.testing.assert_array_equal(
        T_ops.w8a8_matmul(*t, impl="auto").numpy(), got.numpy())
    _eq(R_ql.int8_dot(*j), T_ql.int8_dot(*t))


@pytest.mark.parametrize("m,k,n", W4A8_SHAPES)
def test_w4a8_plain_close_to_reference(m, k, n):
    j, t = _operands(m, k, n, seed=20 + m, pow2=True)
    got = T_ops.w4a8_matmul(*t, impl="ref").numpy()
    assert got.shape == (m, n)
    for want in (R_ops.w4a8_matmul(*j, impl="ref"),
                 R_ops.w4a8_matmul(*j, impl="interpret", bm=16, bn=16,
                                   bk=32)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(
        T_ops.w4a8_matmul(*t, impl="auto").numpy(), got)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_plain_out_dtypes(out_dtype):
    _, t = _operands(8, 64, 24, seed=5, pow2=False)
    assert T_ops.w8a8_matmul(*t, out_dtype=out_dtype).dtype == out_dtype
    _, t = _operands(8, 64, 24, seed=6, pow2=True)
    assert T_ops.w4a8_matmul(*t, out_dtype=out_dtype).dtype == out_dtype


@pytest.mark.parametrize("fn", ["w8a8_matmul", "w4a8_matmul"])
def test_kernel_route_refuses_cpu_tensors(fn):
    _, t = _operands(4, 32, 16, seed=7, pow2=fn == "w4a8_matmul")
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(T_ops, fn)(*t, impl="kernel")
    with pytest.raises(ValueError, match="impl must be one of"):
        getattr(T_ops, fn)(*t, impl="interpret")


def test_kernel_wrapper_checks_operands():
    _, (xq, wq, xs, ws) = _operands(4, 32, 16, seed=8, pow2=False)
    check = T_w8a8.check_operands
    assert check("f", xq, wq, xs, ws, packed=False) == (4, 32, 16)
    with pytest.raises(ValueError, match="does not contract"):
        check("f", xq, wq[:16], xs, ws, packed=False)
    with pytest.raises(ValueError, match="int8"):
        check("f", xq.to(torch.int32), wq, xs, ws, packed=False)
    with pytest.raises(ValueError, match="w_scale"):
        check("f", xq, wq, xs, ws[..., :3], packed=False)
    with pytest.raises(ValueError, match="contiguous"):
        check("f", xq, wq.T.contiguous().T, xs, ws, packed=False)
    big = torch.zeros((1, T_w8a8.MAX_K + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32 sum"):
        check("f", big, torch.zeros((T_w8a8.MAX_K + 1, 1), dtype=torch.int8),
              xs, ws[..., :1], packed=False)


# ------------------------------------------------------------- serve_dot

@pytest.mark.parametrize("mode", ["w8a8", "w4a8_pow2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_dot_matches_reference(mode, dtype):
    w = _normal(30, (96, 40))
    x = _normal(31, (2, 3, 96))
    qj = R_ql.quantize_weight(jnp.asarray(w), R_policy.policy_for(mode))
    qt = T_ql.quantize_weight(torch.from_numpy(w), T_policy.policy_for(mode))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(R_ql.serve_dot(xj, qj).astype(jnp.float32))
    got = T_ql.serve_dot(xt, qt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 3, 40)
    got = got.to(torch.float32).numpy()
    if mode == "w8a8":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:   # a float32 difference may cross a bf16 rounding boundary
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-5)
    np.testing.assert_array_equal(
        T_ql.qdot(xt, qt, T_policy.policy_for(mode), train=False)
        .to(torch.float32).numpy(), got)


def test_qdot_eval_and_training_branches():
    policy = T_policy.policy_for("w8a8")
    w = torch.from_numpy(_normal(40, (16, 8)))
    x = torch.from_numpy(_normal(41, (2, 3, 16)))
    out = T_ql.qdot(x, w, policy, train=False)
    want = R_ql.qdot(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                     R_policy.policy_for("w8a8"), train=False)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    # the QAT branch (once refused): the reference's bit for bit
    qat = R_ql.qdot(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                    R_policy.policy_for("w8a8"), train=True)
    np.testing.assert_array_equal(
        T_ql.qdot(x, w, policy, train=True).float().numpy(),
        np.asarray(qat.astype(jnp.float32)))


# ------------------------------------------------------ policy, configs

def test_policy_matches_reference():
    for pe, mode in R_policy.PE_TO_MODE.items():
        assert T_policy.mode_for_pe(pe.value).value == mode.value
        assert T_policy.pe_for_mode(mode.value).value == pe.value
        rp, tp = R_policy.policy_for(mode.value), \
            T_policy.policy_for(mode.value)
        assert (tp.quantized, tp.weight_bits, tp.act_bits) == \
            (rp.quantized, rp.weight_bits, rp.act_bits)
        assert str(tp.compute_dtype).split(".")[-1] == \
            jnp.dtype(rp.compute_dtype).name
    assert T_policy.policy_for(None).mode == T_policy.ExecMode.BF16
    with pytest.raises(ValueError, match="no execution-mode mapping"):
        T_policy.mode_for_pe("int3")
    with pytest.raises(ValueError, match="no PE-type mapping"):
        T_policy.pe_for_mode("int3")


@pytest.mark.parametrize("arch", T_configs.ALL_ARCHS)
def test_configs_match_reference(arch):
    r, t = R_configs.get_config(arch), T_configs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert t.n_params() == r.n_params()
    assert t.n_active_params() == r.n_active_params()
    assert dataclasses.asdict(T_base.reduced(t)) == \
        dataclasses.asdict(R_base.reduced(r))
    assert T_base.get_config(arch) is t


def test_config_registry_refuses_unported_archs():
    """An arch name no config has is refused; all ten of the reference's
    are registered, and the vlm family's parameter count is the
    reference's."""
    with pytest.raises(KeyError, match="unknown arch"):
        T_configs.get_config("llama-4-vision-400b")
    assert set(T_configs.ALL_ARCHS) == set(R_configs.ALL_ARCHS)
    vlm = dataclasses.replace(T_configs.get_config("phi4-mini-3.8b"),
                              family="vlm", cross_attn_every=4)
    r_vlm = dataclasses.replace(R_configs.get_config("phi4-mini-3.8b"),
                                family="vlm", cross_attn_every=4)
    assert vlm.n_params() == r_vlm.n_params()
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in T_base.SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind)
         for k, v in R_base.SHAPES.items()}
