"""The port's training stack against the reference: the STE quantizers,
QAT ``qdot`` and experts, AdamW, the train step, and the rule that keeps
the kernels (which have no backward) off the autograd graph.

* ``ste`` / ``fake_quant`` / the six per-kind wrappers: forward bit for
  bit the reference's (``x + (qdq - x)``, not ``qdq``), gradient the
  identity.  ``qdot(train=True)`` under W8A8 and W4A8: bit for bit.
* ``adamw``: the schedule bit for bit; ``update`` within 1e-6 of each
  leaf's largest magnitude (the reference's fused elementwise chain and
  its norm's sum order round a few elements 1 ulp apart).  The decayed leaves are exactly the
  reference's ``ndim >= 2`` leaves of its stacked tree.
* The train step on reduced mamba2 (SSM), phi4-mini (dense), moonshot
  (MoE, experts under QAT) and whisper (audio, fp32: the encoder and
  cross layers, one ``ctx`` array fed to both packages), params carried
  over from the reference's
  ``Model.init``: the step-0 loss and every leaf's gradient against
  ``jax.value_and_grad(model.loss)``, then 3 steps of ``make_train_step``
  on both.  Bars:

  - ``fp32`` policy: losses 1e-5 relative (measured <= 1.8e-7), each
    leaf's gradient 1e-5 of its largest magnitude (measured <= 6e-7),
    params after 3 steps 1e-3 of their largest magnitude (measured <=
    1.3e-4: Adam divides by sqrt(v), so near-zero gradients carry their
    rounding into whole steps);
  - ``w8a8`` QAT (bf16 compute): the step-0 loss 2.5e-4 (measured <=
    1.04e-4, moonshot), the later steps' losses 1e-3 (measured <= 4.1e-4,
    phi4 at step 2: the bf16 updates part the two trajectories), each
    leaf's gradient 5e-2 of its largest magnitude (measured <= 2.5e-2;
    bf16 alone gives <= 8.5e-3, the rest is fake-quant codes flipped by a
    bf16 ulp).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.launch.train import make_train_step as r_make_train_step
from repro.models.model import Model as RModel
from repro.optim import adamw as RA
from repro.quant import policy as RP
from repro.quant import qlinear as RQL
from repro.quant import quantizers as RQ
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as T_flash
from repro_torch.kernels import ops
from repro_torch.kernels import w8a8_decode as T_dec
from repro_torch.kernels import w8a8_matmul as T_w8a8
from repro_torch.launch import train as T_train
from repro_torch.models import attention as T_attn
from repro_torch.models.convert import from_reference_params
from repro_torch.models.model import Model
from repro_torch.models.tree import tree_map
from repro_torch.optim import adamw as TA
from repro_torch.quant import policy as TP
from repro_torch.quant import qlinear as TQL
from repro_torch.quant import quantizers as TQ
from test_torch_serve import to_numpy_tree

KINDS = [("int", 8, None), ("int", 8, 0), ("int", 16, None), ("int", 4, 1),
         ("pow2", None, None), ("pow2", None, 0),
         ("pow2_2term", None, None), ("pow2_2term", None, 1),
         ("none", None, None)]


def _x(seed=3, shape=(48, 40)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind,bits,axis", KINDS)
def test_fake_quant_forward_and_gradient(kind, bits, axis):
    x = _x()
    want = np.asarray(RQ.fake_quant(jnp.asarray(x),
                                    RQ.FakeQuantSpec(kind, bits, axis)))
    t = torch.from_numpy(x).requires_grad_(True)
    got = TQ.fake_quant(t, TQ.FakeQuantSpec(kind, bits, axis))
    assert np.array_equal(got.detach().numpy(), want)
    up = torch.from_numpy(_x(4))
    got.backward(up)
    assert torch.equal(t.grad, up)


def test_ste_keeps_the_reference_arithmetic():
    """``ste`` returns ``x + (qdq - x)`` as the reference does, which in
    float32 is ``qdq`` only where ``qdq - x`` is exact (always for the
    quantizers' own outputs, within a factor 2 of x): against an unrelated
    ``qdq`` the two differ."""
    x = _x(5, (256, 64)) * 3
    q = _x(9, (256, 64)) * 1e3
    got = TQ.ste(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    want = np.asarray(RQ.ste(jnp.asarray(x), jnp.asarray(q)))
    assert np.array_equal(got, want)
    assert not np.array_equal(got, q)


@pytest.mark.parametrize("name,args", [
    ("quantize_dequantize_int", (8, 0)), ("quantize_dequantize_int", (4,)),
    ("quantize_dequantize_pow2", ()), ("quantize_dequantize_pow2", (1,)),
    ("quantize_dequantize_pow2_2term", (0,)),
    ("fake_quant_int", (8,)), ("fake_quant_int", (16, 1)),
    ("fake_quant_pow2", (0,)), ("fake_quant_pow2_2term", ())])
def test_per_kind_wrappers_match_reference(name, args):
    x = _x(6)
    want = np.asarray(getattr(RQ, name)(jnp.asarray(x), *args))
    got = getattr(TQ, name)(torch.from_numpy(x), *args).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["w8a8", "w4a8_pow2", "bf16", "fp32"])
def test_qdot_qat_branch_matches_reference(mode):
    x, w = _x(7, (5, 64)), _x(8, (64, 48))
    rpol, tpol = RP.policy_for(mode), TP.policy_for(mode)
    want = RQL.qdot(jnp.asarray(x), jnp.asarray(w), rpol, train=True)
    got = TQL.qdot(torch.from_numpy(x), torch.from_numpy(w), tpol,
                   train=True)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    for fn in ("weight_quant_spec", "act_quant_spec"):
        r, t = getattr(RQL, fn)(rpol), getattr(TQL, fn)(tpol)
        assert (r.kind, r.bits, r.resolved_axis) == \
            (t.kind, t.bits, t.resolved_axis)


# ------------------------------------------------------------- AdamW

def _ref_flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_ref_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(jnp.asarray(v)
                                             .astype(jnp.float32))
    return out


def _port_stacked(tree) -> dict:
    """The port's tree with each stacked leaf's layers stacked, keyed by
    the reference's paths."""
    out = {}
    for path, t, stacked in TA.leaves(tree):
        parts = path.split("/")
        if stacked:
            out.setdefault(f"{parts[0]}/{parts[2]}", []).append(
                t.detach().float().numpy())
        else:
            out[path] = t.detach().float().numpy()
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def _ref_and_port(arch, **over):
    rcfg = dataclasses.replace(r_reduced(r_get_config(arch)), **over)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **over)
    rmodel = RModel(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tparams = from_reference_params(tcfg, to_numpy_tree(rparams),
                                    device="cpu")
    return rmodel, rparams, Model(tcfg, device="cpu"), tparams, tcfg


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-medium",
                                  "moonshot-v1-16b-a3b", "mamba2-130m"])
def test_adamw_decays_exactly_the_reference_leaves(arch):
    """The reference decays its stacked tree's ``ndim >= 2`` leaves: every
    leaf of the layer stacks (norm scales and SSM vectors too) and
    ``embed``, not ``final_norm`` nor the hybrid's shared 1-D leaves."""
    _, rparams, _, tparams, cfg = _ref_and_port(arch)
    want = {path for path, a in _ref_flat(rparams).items() if a.ndim >= 2}
    got = set()
    for path in TA.decayed(tparams):
        parts = path.split("/")
        got.add(f"{parts[0]}/{parts[2]}" if parts[0] in TA.STACKED
                else path)
    assert got == want
    assert "final_norm" not in got and "embed" in got
    assert any(p.startswith("layers/") and p.endswith("ln1") for p in got)
    if cfg.family == "hybrid":
        assert "shared/ln1" not in got and "shared/wq" in got


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-medium",
                                  "moonshot-v1-16b-a3b", "mamba2-130m"])
def test_adamw_update_decays_exactly_the_decayed_leaves(arch):
    """``update`` on zero gradients moves a param only by its decay: each
    leaf of ``decayed`` becomes ``p - lr * wd * p`` and every other leaf
    stays as it was."""
    _, _, _, tparams, _ = _ref_and_port(arch)
    ocfg = TA.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1)
    grads = tree_map(torch.zeros_like, tparams)
    new, _, _ = TA.update(ocfg, grads, TA.init(tparams), tparams)
    lr = TA.schedule(ocfg, 0)
    decay = TA.decayed(tparams)
    moved = set()
    for (path, p, _), (_, q, _) in zip(TA.leaves(tparams), TA.leaves(new)):
        if path in decay:
            pf = p.to(torch.float32)
            want = (pf - lr * (0.0 + ocfg.weight_decay * pf)).to(p.dtype)
            assert torch.equal(q, want), path
        else:
            assert torch.equal(q, p), path
        if not torch.equal(q, p):
            moved.add(path)
    assert moved == {path for path, p in decay.items() if p.any()}


def test_adamw_schedule_matches_reference():
    for cfg in (dict(), dict(warmup_steps=3, total_steps=11,
                             min_lr_ratio=0.25, lr=1e-2)):
        rc, tc = RA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
        for step in (0, 1, 2, 3, 7, 11, 99, 100, 5000, 12000):
            want = np.float32(RA.schedule(rc, jnp.int32(step)))
            got = TA.schedule(tc, step)
            assert got.dtype == torch.float32
            assert np.float32(got) == want, (cfg, step)


@pytest.mark.parametrize("grad_scale", [1e-4, 1e-2])
def test_adamw_update_matches_reference(grad_scale):
    """Five updates of reduced zamba2 (stacked layers and the unstacked
    shared block) on fixed gradients, under the clip (factor 1) and above
    it: params and moments within 1e-6 of each leaf's largest magnitude
    (measured 6.0e-8 under the clip, 5.0e-7 above it: XLA's fused
    elementwise chain and the norm's sum order round a few elements 1 ulp
    apart)."""
    _, rparams, _, tparams, cfg = _ref_and_port("zamba2-1.2b")
    rng = np.random.default_rng(0)
    rgrads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * grad_scale),
        rparams)
    tgrads = from_reference_params(cfg, to_numpy_tree(rgrads), device="cpu")
    rc = RA.AdamWConfig(warmup_steps=2, total_steps=5)
    tc = TA.AdamWConfig(warmup_steps=2, total_steps=5)
    rs, ts = RA.init(rparams), TA.init(tparams)
    worst = 0.0
    for _ in range(5):
        rparams, rs, rm = RA.update(rc, rgrads, rs, rparams)
        tparams, ts, tm = TA.update(tc, tgrads, ts, tparams)
        assert np.float32(tm["lr"]) == np.float32(rm["lr"])
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) \
            <= 1e-6 * float(rm["grad_norm"])
        for rt, tt in ((rparams, tparams), (rs.mu, ts.mu), (rs.nu, ts.nu)):
            want, got = _ref_flat(rt), _port_stacked(tt)
            assert set(want) == set(got)
            for k in want:
                err = np.abs(want[k] - got[k]).max() / np.abs(want[k]).max()
                worst = max(worst, err)
                assert err <= 1e-6, (k, err)
    print(grad_scale, worst)
    assert ts.step == int(rs.step) == 5


# --------------------------------------------------- the train step

TRAIN_CASES = [(a, m) for a in ("mamba2-130m", "phi4-mini-3.8b",
                                "moonshot-v1-16b-a3b")
               for m in ("fp32", "w8a8")] + [("whisper-medium", "fp32")]
BARS = {"fp32": dict(loss0=1e-5, loss=1e-5, grad=1e-5, params=1e-3),
        "w8a8": dict(loss0=2.5e-4, loss=1e-3, grad=5e-2, params=None)}


@pytest.mark.parametrize("arch,mode", TRAIN_CASES)
def test_train_step_matches_reference(arch, mode):
    over = dict(quant=mode)
    if arch == "mamba2-130m":
        over["ssm_chunk"] = 8
    rmodel, rparams, tmodel, tparams, cfg = _ref_and_port(arch, **over)
    bars = BARS[mode]
    dcfg = (cfg.vocab, 16, 3, 5)

    def batches(step):
        rb = RSyntheticLM(RDataConfig(*dcfg)).batch(step)
        tb = SyntheticLM(DataConfig(*dcfg)).batch(step, device="cpu")
        if cfg.family in ("vlm", "audio"):   # one context for both
            tb["ctx"] = T_train.context(cfg, dcfg[2], step, "cpu")
            rb["ctx"] = jnp.asarray(tb["ctx"].numpy())
        return rb, tb

    rb, tb = batches(0)
    rloss, rgrads = jax.value_and_grad(rmodel.loss)(rparams, rb)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    tloss = tmodel.loss(leaves, tb)
    tloss.backward()
    tloss = tloss.detach()
    rel = abs(float(tloss) - float(rloss)) / abs(float(rloss))
    print(arch, mode, "loss", float(tloss), float(rloss), rel)
    assert rel <= bars["loss0"]
    want = _ref_flat(rgrads)
    got = _port_stacked(tree_map(lambda p: p.grad, leaves))
    assert set(got) == set(want)
    worst = max((np.abs(want[k] - got[k]).max() / np.abs(want[k]).max(), k)
                for k in want)
    print(arch, mode, "grad", worst)
    assert worst[0] <= bars["grad"], worst

    rc = RA.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=1)
    tc = TA.AdamWConfig(lr=3e-3, total_steps=3, warmup_steps=1)
    rstep = r_make_train_step(rmodel, make_host_mesh(), rc)
    tstep = T_train.make_train_step(tmodel, None, tc)
    rs = {"params": rparams, "opt": RA.init(rparams), "err": {}}
    ts = {"params": tparams, "opt": TA.init(tparams), "err": {}}
    for step in range(3):
        rb, tb = batches(step)
        rs, rloss = rstep(rs, rb)
        ts, tloss = tstep(ts, tb)
        rel = abs(float(tloss) - float(rloss)) / abs(float(rloss))
        print(arch, mode, "step", step, float(tloss), float(rloss), rel)
        assert rel <= bars["loss0" if step == 0 else "loss"]
    if bars["params"] is not None:
        want, got = _ref_flat(rs["params"]), _port_stacked(ts["params"])
        for k in want:
            err = np.abs(want[k] - got[k]).max()
            assert err <= bars["params"] * np.abs(want[k]).max(), (k, err)


def test_expert_ffn_qat_quantizes_gate_and_in_only():
    """Under QAT the experts' gate and in products fake-quantize (weights
    per output channel, axis 1 of (E, d, ff)); the out product does not,
    as in the reference's ``edot``."""
    from repro_torch.models import moe as T_moe
    rng = np.random.default_rng(2)
    buf = torch.from_numpy(rng.normal(size=(4, 3, 16)).astype(np.float32))
    p = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in (("w_experts_gate", (4, 16, 24)),
                      ("w_experts_in", (4, 16, 24)),
                      ("w_experts_out", (4, 24, 16)))}
    pol = TP.policy_for("w8a8")
    got = T_moe.expert_ffn(buf, p, pol, train=True)
    cd = pol.compute_dtype

    def edot(a, w):
        return torch.bmm(TQL.qat_act(a, pol).to(cd),
                         TQL.qat_weight(w, pol, axis=1).to(cd))
    h = torch.nn.functional.silu(edot(buf, p["w_experts_gate"])) \
        * edot(buf, p["w_experts_in"])
    assert torch.equal(got, torch.bmm(h.to(cd), p["w_experts_out"].to(cd)))
    assert not torch.equal(got, T_moe.expert_ffn(buf, p, pol, train=False))


# ------------------------------------------------------ train() itself

@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "gemma3-4b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_train_loss_falls_on_every_family(arch):
    losses = T_train.train(arch, steps=8, batch=2, seq_len=16,
                           log_every=100, device="cpu")
    assert [s for s, _ in losses] == list(range(8))
    assert all(np.isfinite(l) for _, l in losses)
    assert losses[-1][1] < losses[0][1]


def test_train_is_reproducible_and_context_seeded():
    a = T_train.train("whisper-medium", steps=2, batch=2, seq_len=16,
                      device="cpu")
    b = T_train.train("whisper-medium", steps=2, batch=2, seq_len=16,
                      device="cpu")
    assert a == b
    cfg = reduced(get_config("whisper-medium"))
    c0 = T_train.context(cfg, 2, 0, "cpu")
    assert c0.shape == (2, cfg.n_ctx_tokens, cfg.d_model)
    assert torch.equal(c0, T_train.context(cfg, 2, 0, "cpu"))
    assert not torch.equal(c0, T_train.context(cfg, 2, 1, "cpu"))


@pytest.mark.parametrize("kwargs,steps", [
    (dict(ckpt_every=3), [0, 1, 2, 3]),
    (dict(ckpt_every=2, fail_at={3: 1}), [0, 1, 2, 2, 3]),
    (dict(grad_compression=True), [0, 1, 2, 3])])
def test_train_runs_the_checkpoint_and_compression_knobs(tmp_path, kwargs,
                                                         steps):
    """``ckpt_dir`` / ``ckpt_every`` / ``fail_at`` run the restarting
    loop (a failure at step 3 replays step 2 from step 1's checkpoint) and
    give the plain loop's losses; ``grad_compression`` trains on int8
    round-tripped gradients."""
    kw = dict(steps=4, batch=2, seq_len=16, log_every=100, device="cpu")
    ckpt = {} if "grad_compression" in kwargs else \
        dict(ckpt_dir=str(tmp_path))
    losses = T_train.train("mamba2-130m", **kw, **ckpt, **kwargs)
    assert [s for s, _ in losses] == steps
    assert all(np.isfinite(l) for _, l in losses)
    plain = T_train.train("mamba2-130m", **kw)
    assert (dict(losses) == dict(plain)) == ("grad_compression" not in kwargs)
    if ckpt:
        assert sorted(os.listdir(tmp_path))[-1] == "step_00000003"


def test_train_main_cli(capsys):
    T_train.main(["--arch", "mamba2-130m", "--steps", "3", "--batch", "2",
                  "--seq-len", "16", "--device", "cpu"])
    assert "loss:" in capsys.readouterr().out


def test_train_main_cli_checkpoints_and_compresses(tmp_path, capsys):
    T_train.main(["--arch", "mamba2-130m", "--steps", "3", "--batch", "2",
                  "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
                  str(tmp_path), "--grad-compression"])
    out = capsys.readouterr().out
    assert "restarts=0 stragglers=0" in out and "loss:" in out
    assert os.listdir(tmp_path) == ["step_00000002"]


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T_train.train("mamba2-130m", steps=1)


# ------------------------------------------ the kernels stay off the graph

@pytest.fixture
def kernels_everywhere(monkeypatch):
    """``"auto"`` finds every tensor on a kernel device, and the kernel
    wrappers count their calls and return their plain versions."""
    calls = {"flash": 0, "w8a8": 0, "decode": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run
    monkeypatch.setattr(ops, "on_card", lambda x: True)
    monkeypatch.setattr(T_flash, "flash_attention",
                        counted("flash", T_flash.flash_attention_ref))
    monkeypatch.setattr(T_w8a8, "w8a8_matmul",
                        counted("w8a8", T_w8a8.w8a8_matmul_ref))
    monkeypatch.setattr(T_dec, "w8a8_decode_attention_body",
                        counted("decode",
                                T_dec.w8a8_decode_attention_body_ref))
    return calls


def test_grad_rule_routes_attention_and_matmuls(kernels_everywhere):
    calls = kernels_everywhere
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    with torch.no_grad():
        T_attn.attend(q, k, v)
    assert calls["flash"] == 1
    q.requires_grad_(True)
    out = T_attn.attend(q, k, v)
    assert calls["flash"] == 1 and out.grad_fn is not None
    assert torch.equal(out, T_attn.dense_attention(q, k, v))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), impl="kernel")
    # the quantized matmul: x's scale carries the gradient
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    qw = TQL.quantize_weight(torch.from_numpy(
        rng.normal(size=(64, 32)).astype(np.float32)), TP.policy_for("w8a8"))
    TQL.serve_dot(x, qw)
    assert calls["w8a8"] == 1
    x.requires_grad_(True)
    y = TQL.serve_dot(x, qw)
    assert calls["w8a8"] == 1
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_loss_under_grad_reaches_no_kernel(kernels_everywhere):
    """Reduced phi4-mini's QAT loss under grad with every tensor counted
    as on a kernel device: no kernel is reached, and every leaf's gradient
    equals the plain CPU route's; under ``no_grad`` flash launches once a
    layer."""
    calls = kernels_everywhere
    cfg = reduced(get_config("phi4-mini-3.8b"))        # w8a8 policy
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    batch = SyntheticLM(DataConfig(cfg.vocab, 16, 2)).batch(0, "cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    model.loss(leaves, batch).backward()
    assert calls == {"flash": 0, "w8a8": 0, "decode": 0}
    ref = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ref_model = Model(cfg, device="cpu", impl="ref")
    ref_model.loss(ref, batch).backward()
    for (path, a, _), (_, b, _) in zip(TA.leaves(leaves), TA.leaves(ref)):
        assert a.grad is not None and torch.equal(a.grad, b.grad), path
    with torch.no_grad():
        model.loss(params, batch, train=False)
    assert calls["flash"] == cfg.n_layers
