"""The plain reference against the port on the CPU at a small size, the
control (every int8 operand at int4) failing where the program passes,
and the reference's quantizers."""

import pytest
import torch

from conftest import TINY_CONFIG, TINY_LIMITS
from portbench.harness import main, program, spec, traffic
from portbench.reference import dense

SMALL = {**TINY_CONFIG, "hidden_size": 256, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 512,
         "vocab_size": 2048, "num_hidden_layers": 3}
LENGTHS = (32, 97, 160)


def readings(conf, seed):
    shape = spec.model_shape("small", conf)
    model, params = program.build(shape, seed, "cpu")
    pool = traffic.token_pool(seed, shape.vocab, "cpu")
    prompts = [pool[i * 200:i * 200 + s] for i, s in enumerate(LENGTHS)]
    with torch.no_grad():
        served = [program.serve(model, params, p) for p in prompts]
        ref = dense.Reference(shape).last_logits(seed, prompts, "cpu")
        low = dense.Reference(shape, act_bits=4, weight_bits=4).last_logits(
            seed, prompts, "cpu")
    return dense.numbers(served, ref), dense.numbers(low, ref)


@pytest.mark.parametrize("quant,act", [("w4a8_pow2", "silu"),
                                       ("w8a8", "gelu_pytorch_tanh")])
@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_program_near_the_reference_control_far(quant, act, seed):
    prog, control = readings({**SMALL, "quant": quant, "hidden_act": act},
                             seed)
    limits = TINY_LIMITS["limits"]
    assert prog["logit_err"] < 0.05
    assert control["logit_err"] > 3 * prog["logit_err"]
    assert prog["logit_err"] <= limits["logit_err"] < control["logit_err"]
    assert control["logit_cos_dist"] > 3 * prog["logit_cos_dist"]
    assert prog["top_gap"] <= limits["top_gap"]


def test_numbers_of_identical_logits_are_zero():
    r = torch.randn(1000)
    same = dense.numbers([r], [r])
    assert same["top_gap"] == same["logit_err"] == 0.0
    assert abs(same["logit_cos_dist"]) < 1e-6
    wrong = r.clone()
    wrong[int(r.argmin())] = r.max() + 1
    got = dense.numbers([wrong], [r])
    assert got["top_gap"] == pytest.approx(float((r.max() - r.min())
                                                 / r.std()))
    assert dense.numbers([torch.full((1000,), float("nan"))], [r]) == \
        dict.fromkeys(dense.NUMBERS, float("inf"))
    assert dense.numbers([-r], [r])["logit_cos_dist"] == pytest.approx(2.0)


def test_pow2_weights_are_signed_powers_of_two_of_the_column_max():
    w = torch.randn(64, 8)
    q = dense.dequant_weight(w, "w4a8_pow2", 8)
    amax = w.abs().amax(dim=0, keepdim=True)
    e = torch.log2(q.abs() / amax)
    assert torch.equal(e, torch.round(e))
    assert float(e.min()) >= -7 and float(e.max()) <= 0
    assert torch.equal(torch.sign(q), torch.where(w < 0, -1.0, 1.0))
    assert torch.allclose(q.abs().amax(dim=0, keepdim=True), amax)


@pytest.mark.parametrize("bits", [8, 4])
def test_int_weights_round_to_the_column_grid(bits):
    w = torch.randn(64, 8)
    q = dense.dequant_weight(w, "w8a8", bits)
    step = w.abs().amax(dim=0, keepdim=True) / (2 ** (bits - 1) - 1)
    assert torch.all((q - w).abs() <= step / 2 + 1e-7)
    assert torch.allclose(q / step, torch.round(q / step), atol=1e-4)


def test_activations_per_tensor():
    x = torch.randn(16, 32)
    q = dense.quantize_act(x, 8)
    step = x.abs().max() / 127
    assert torch.all((q - x).abs() <= step / 2 + 1e-7)
    assert len(torch.unique(dense.quantize_act(x, 4))) <= 15


def test_blocked_attention_equals_the_whole_softmax(monkeypatch):
    monkeypatch.setattr(dense, "Q_BLOCK", 7)
    s, h, kvh, hd = 20, 4, 2, 8
    q, k, v = torch.randn(s, h, hd), torch.randn(s, kvh, hd), \
        torch.randn(s, kvh, hd)
    kr = k.repeat_interleave(2, dim=1)
    vr = v.repeat_interleave(2, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, kr) / hd ** 0.5
    scores = scores.masked_fill(torch.ones(s, s).triu(1).bool(),
                                float("-inf"))
    want = torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), vr)
    assert torch.allclose(dense.causal_attention(q, k, v), want, atol=1e-5)


@pytest.mark.cuda
def test_control_fails_at_full_width_on_the_card(cuda_device):
    """The control at phi4-mini's widths, 4 of its 32 layers, three
    seeds: the int4 control reads several times the program."""
    import json
    from conftest import ROOT
    conf = json.loads((ROOT / "portbench" / "configs" /
                       "phi4-mini-3.8b.w4a8.json").read_text())
    conf["num_hidden_layers"] = 4
    shape = spec.model_shape("phi4-4l", conf)
    for seed in (11, 12, 13):
        model, params = program.build(shape, seed, cuda_device)
        pool = traffic.token_pool(seed, shape.vocab, cuda_device)
        prompts = [pool[:1024], pool[5000:5000 + 300]]
        with torch.no_grad():
            served = [program.serve(model, params, p).cpu() for p in prompts]
        del model, params
        ref = main.reference_logits(shape, seed, prompts, cuda_device)
        low = main.reference_logits(shape, seed, prompts, cuda_device,
                                    act_bits=4, weight_bits=4)
        prog = dense.numbers(served, ref)
        control = dense.numbers([x.cpu() for x in low], ref)
        assert control["logit_cos_dist"] > 3 * prog["logit_cos_dist"]
