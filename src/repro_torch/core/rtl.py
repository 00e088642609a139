"""RTL generation for the QAPPA accelerator template.

Copy of :mod:`repro.core.rtl`; its text is the reference's byte for byte
(``tests/test_torch_ppa_rtl.py``).

The paper's framework "generates RTL output based on the input hardware
configuration" so designers "can also use the automatically generated RTL
code to follow the design synthesis flow" (Sec. 3.1) — the stated
differentiator vs SCALE-Sim / Aladdin (Sec. 2).  This module emits
synthesizable Verilog-2001 for one :class:`AcceleratorConfig`:

* a MAC unit per PE type — behavioural fp32 stub, int16 multiplier, or
  the LightPE shift / shift-add datapaths (sign|exp coded weights);
* per-PE scratchpads (ifmap / filter / psum) as inferred-BRAM register
  arrays of the config's quantization-aware widths/depths;
* the PE (datapath + spads + row-stationary control handshake);
* the 2-D array with row-broadcast ifmap, column psum chaining, and a
  global-buffer port per column.

The reference's tests/test_rtl.py checks structural invariants (module
set, port widths, spad depths, shift-datapath presence for LightPEs,
balanced begin/end).
"""

from __future__ import annotations

import math

from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.pe import PEType


def _clog2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(2, n))))


def _mac_module(cfg: AcceleratorConfig) -> str:
    s = cfg.spec
    a, w, p = s.act_bits, s.weight_bits, s.psum_bits
    hdr = (f"module mac_unit #(parameter AW={a}, WW={w}, PW={p}) (\n"
           "  input  wire clk,\n  input  wire en,\n"
           f"  input  wire signed [AW-1:0] act,\n"
           f"  input  wire [WW-1:0] weight,\n"
           f"  input  wire signed [PW-1:0] psum_in,\n"
           f"  output reg  signed [PW-1:0] psum_out\n);\n")
    if cfg.pe_type == PEType.FP32:
        body = (
            "  // behavioural fp32 MAC stub; synthesis binds an FPU macro\n"
            "  wire signed [PW-1:0] prod;\n"
            "  fp32_mac_macro u_fp (.a(act), .b(weight), .p(prod));\n"
            "  always @(posedge clk) if (en) psum_out <= psum_in + prod;\n")
    elif cfg.pe_type == PEType.INT16:
        body = (
            "  wire signed [WW-1:0] w_s = weight;\n"
            "  wire signed [AW+WW-1:0] prod = act * w_s;\n"
            "  always @(posedge clk) if (en)\n"
            "    psum_out <= psum_in + {{(PW-AW-WW){prod[AW+WW-1]}}, prod};\n")
    elif cfg.pe_type == PEType.LIGHTPE1:
        body = (
            "  // LightPE-1: one barrel shift (weight = sign|3-bit exp)\n"
            "  wire        w_sign = weight[3];\n"
            "  wire [2:0]  w_exp  = weight[2:0];\n"
            "  wire signed [PW-1:0] act_ext = {{(PW-AW){act[AW-1]}}, act};\n"
            "  wire signed [PW-1:0] shifted = act_ext <<< w_exp;\n"
            "  wire signed [PW-1:0] addend  = w_sign ? -shifted : shifted;\n"
            "  always @(posedge clk) if (en) psum_out <= psum_in + addend;\n")
    else:  # LIGHTPE2: two shifts + add (weight = sign|exp1|exp2 packed)\n
        body = (
            "  // LightPE-2: two shifts + add (sum of <=2 powers of two)\n"
            "  wire        w_sign = weight[7];\n"
            "  wire [2:0]  w_exp1 = weight[6:4];\n"
            "  wire [2:0]  w_exp2 = weight[2:0];\n"
            "  wire        w_two  = weight[3];\n"
            "  wire signed [PW-1:0] act_ext = {{(PW-AW){act[AW-1]}}, act};\n"
            "  wire signed [PW-1:0] sh1 = act_ext <<< w_exp1;\n"
            "  wire signed [PW-1:0] sh2 = w_two ? (act_ext <<< w_exp2)"
            " : {PW{1'b0}};\n"
            "  wire signed [PW-1:0] mag = sh1 + sh2;\n"
            "  wire signed [PW-1:0] addend = w_sign ? -mag : mag;\n"
            "  always @(posedge clk) if (en) psum_out <= psum_in + addend;\n")
    return hdr + body + "endmodule\n"


def _spad_module(name: str, width: int, depth: int) -> str:
    aw = _clog2(depth)
    return (
        f"module {name}_spad #(parameter W={width}, D={depth}, A={aw}) (\n"
        "  input  wire clk,\n  input  wire we,\n"
        "  input  wire [A-1:0] waddr,\n  input  wire [A-1:0] raddr,\n"
        "  input  wire [W-1:0] wdata,\n  output reg  [W-1:0] rdata\n);\n"
        f"  reg [W-1:0] mem [0:D-1];\n"
        "  always @(posedge clk) begin\n"
        "    if (we) mem[waddr] <= wdata;\n"
        "    rdata <= mem[raddr];\n  end\nendmodule\n")


def _pe_module(cfg: AcceleratorConfig) -> str:
    s = cfg.spec
    a, w, p = s.act_bits, s.weight_bits, s.psum_bits
    ia = _clog2(cfg.ifmap_spad)
    fa = _clog2(cfg.filter_spad)
    pa = _clog2(cfg.psum_spad)
    return (
        "module pe (\n"
        "  input  wire clk, rst, en,\n"
        f"  input  wire [{a - 1}:0] ifmap_in,\n"
        f"  input  wire [{w - 1}:0] filter_in,\n"
        "  input  wire ifmap_we, filter_we,\n"
        f"  input  wire [{ia - 1}:0] ifmap_addr,\n"
        f"  input  wire [{fa - 1}:0] filter_addr,\n"
        f"  input  wire [{pa - 1}:0] psum_addr,\n"
        f"  input  wire signed [{p - 1}:0] psum_in,\n"
        f"  output wire signed [{p - 1}:0] psum_out\n);\n"
        f"  wire [{a - 1}:0] act_r;\n"
        f"  wire [{w - 1}:0] wgt_r;\n"
        f"  wire signed [{p - 1}:0] mac_out;\n"
        "  ifmap_spad  u_if (.clk(clk), .we(ifmap_we), .waddr(ifmap_addr),\n"
        "                    .raddr(ifmap_addr), .wdata(ifmap_in),"
        " .rdata(act_r));\n"
        "  filter_spad u_fl (.clk(clk), .we(filter_we),"
        " .waddr(filter_addr),\n"
        "                    .raddr(filter_addr), .wdata(filter_in),"
        " .rdata(wgt_r));\n"
        "  mac_unit    u_mac (.clk(clk), .en(en), .act($signed(act_r)),\n"
        "                     .weight(wgt_r), .psum_in(psum_in),"
        " .psum_out(mac_out));\n"
        "  assign psum_out = mac_out;\n"
        "endmodule\n")


def _array_module(cfg: AcceleratorConfig) -> str:
    s = cfg.spec
    a, w, p = s.act_bits, s.weight_bits, s.psum_bits
    r, c = cfg.pe_rows, cfg.pe_cols
    glb_aw = _clog2(cfg.glb_kb * 1024)
    lines = [
        f"// QAPPA spatial array: {cfg.name()}",
        f"// {r}x{c} {cfg.pe_type.pretty} PEs, row-stationary dataflow",
        "module pe_array (",
        "  input  wire clk, rst, en,",
        f"  input  wire [{a * r - 1}:0] ifmap_rows,    // one act per row",
        f"  input  wire [{w * c - 1}:0] filter_cols,   // one wgt per col",
        "  input  wire ifmap_we, filter_we,",
        f"  input  wire [{glb_aw - 1}:0] glb_addr,",
        f"  output wire [{p * c - 1}:0] psum_cols      // column outputs",
        ");",
        f"  wire signed [{p - 1}:0] psum_chain [0:{r}][0:{c - 1}];",
        "  genvar gi, gj;",
        "  generate",
        f"    for (gj = 0; gj < {c}; gj = gj + 1) begin : col",
        f"      assign psum_chain[0][gj] = {{{p}{{1'b0}}}};",
        f"      for (gi = 0; gi < {r}; gi = gi + 1) begin : row",
        "        pe u_pe (",
        "          .clk(clk), .rst(rst), .en(en),",
        f"          .ifmap_in(ifmap_rows[gi*{a} +: {a}]),",
        f"          .filter_in(filter_cols[gj*{w} +: {w}]),",
        "          .ifmap_we(ifmap_we), .filter_we(filter_we),",
        f"          .ifmap_addr({{{_clog2(cfg.ifmap_spad)}{{1'b0}}}}),",
        f"          .filter_addr({{{_clog2(cfg.filter_spad)}{{1'b0}}}}),",
        f"          .psum_addr({{{_clog2(cfg.psum_spad)}{{1'b0}}}}),",
        "          .psum_in(psum_chain[gi][gj]),",
        "          .psum_out(psum_chain[gi+1][gj])",
        "        );",
        "      end",
        f"      assign psum_cols[gj*{p} +: {p}] = psum_chain[{r}][gj];",
        "    end",
        "  endgenerate",
        "endmodule",
    ]
    return "\n".join(lines) + "\n"


def generate_rtl(cfg: AcceleratorConfig) -> str:
    """Full Verilog for one design point (the paper's RTL output)."""
    s = cfg.spec
    parts = [
        f"// Generated by QAPPA-repro for config: {cfg.name()}",
        f"// PE type: {cfg.pe_type.pretty}  act={s.act_bits}b "
        f"wgt={s.weight_bits}b psum={s.psum_bits}b",
        f"// array {cfg.pe_rows}x{cfg.pe_cols}, GLB {cfg.glb_kb} kB, "
        f"BW {cfg.dram_bw_gbps} GB/s",
        "",
        _mac_module(cfg),
        _spad_module("ifmap", s.act_bits, cfg.ifmap_spad),
        _spad_module("filter", s.weight_bits, cfg.filter_spad),
        _spad_module("psum", s.psum_bits, cfg.psum_spad),
        _pe_module(cfg),
        _array_module(cfg),
    ]
    return "\n".join(parts)


def rtl_stats(rtl: str) -> dict:
    """Crude structural stats for validation/reporting."""
    return {
        "modules": rtl.count("\nmodule ") + rtl.startswith("module "),
        "endmodules": rtl.count("endmodule"),
        "has_shift": "<<<" in rtl,
        "has_multiplier": "act * " in rtl,
        "lines": rtl.count("\n") + 1,
    }
