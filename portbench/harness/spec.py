"""The cell a run measures, read from ``BENCHMARK.json`` and the data
files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Its configuration's ``file`` holds the model as it is run, in the
published ``config.json``'s keys; ``traffic/<traffic>.json`` holds the
mix's parameters and ``limits/<cell>.json`` the limits of its output
comparison.  The metrics a cell reports are the ``end_to_end`` and
``per_layer`` entries without a ``workloads`` key, or whose ``workloads``
list the cell.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

#: published activation names -> the MLP the port builds for them
MLP_KINDS = {"silu": "swiglu", "gelu_pytorch_tanh": "gelu"}


@dataclasses.dataclass(frozen=True)
class ModelShape:
    """The sizes of a dense decoder as it is run: what the harness hands
    the port's ``ArchConfig``, the reference and the roofline counters."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp: str             # "swiglu" | "gelu"
    quant: str           # "w8a8" | "w4a8_pow2"
    rope_theta: float
    norm_eps: float

    @property
    def projections(self) -> tuple[tuple[str, int, int], ...]:
        """Each quantized projection of a layer: (name, d_in, d_out)."""
        d, h, kvh, hd, ff = (self.d_model, self.n_heads, self.n_kv_heads,
                             self.head_dim, self.d_ff)
        out = [("wq", d, h * hd), ("wk", d, kvh * hd), ("wv", d, kvh * hd),
               ("wo", h * hd, d)]
        if self.mlp == "swiglu":
            out.append(("w_gate", d, ff))
        return tuple(out + [("w_up", d, ff), ("w_down", ff, d)])


def model_shape(name: str, conf: dict) -> ModelShape:
    """A configuration file's keys as a :class:`ModelShape`."""
    heads = int(conf["num_attention_heads"])
    d = int(conf["hidden_size"])
    act = conf["hidden_act"]
    if act not in MLP_KINDS:
        raise ValueError(f"{name}: no MLP for hidden_act {act!r}")
    return ModelShape(
        name=name, n_layers=int(conf["num_hidden_layers"]), d_model=d,
        n_heads=heads, n_kv_heads=int(conf["num_key_value_heads"]),
        head_dim=int(conf.get("head_dim") or d // heads),
        d_ff=int(conf["intermediate_size"]), vocab=int(conf["vocab_size"]),
        mlp=MLP_KINDS[act], quant=conf["quant"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf.get("rms_norm_eps", conf.get("norm_epsilon"))))


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    model: ModelShape
    traffic: dict
    limits: dict
    end_to_end: tuple     # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    ``KeyError`` for a name the file does not hold."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(root / confs[w["config"]]["file"])
    bench_dir = root / bench["paths"][0]
    return Cell(
        name=name, chips=int(w["chips"]),
        model=model_shape(w["config"], conf),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)))
