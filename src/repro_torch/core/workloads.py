"""Layer-wise DNN configurations (the paper's workload input).

Copy of :mod:`repro.core.workloads`: VGG-16, ResNet-34 and ResNet-50 at
ImageNet-224 shapes.  A layer is a conv ``(H, W, C, K, R, S, stride)`` or an
FC (conv with R=S=H=W=1).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    h: int
    w: int
    c: int
    k: int
    r: int = 3
    s: int = 3
    stride: int = 1
    batch: int = 1

    @property
    def e(self) -> int:  # output height
        return max(1, (self.h - self.r) // self.stride + 1)

    @property
    def f(self) -> int:  # output width
        return max(1, (self.w - self.s) // self.stride + 1)

    @property
    def macs(self) -> int:
        return self.batch * self.k * self.c * self.r * self.s * self.e * self.f


def fc(name: str, cin: int, cout: int, batch: int = 1) -> ConvLayer:
    return ConvLayer(name=name, h=1, w=1, c=cin, k=cout, r=1, s=1,
                     stride=1, batch=batch)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    layers: tuple[ConvLayer, ...]

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)


def vgg16() -> Workload:
    ls: list[ConvLayer] = []
    cfg = [  # (h, c, k, repeat)
        (224, 3, 64, 1), (224, 64, 64, 1),
        (112, 64, 128, 1), (112, 128, 128, 1),
        (56, 128, 256, 1), (56, 256, 256, 2),
        (28, 256, 512, 1), (28, 512, 512, 2),
        (14, 512, 512, 3),
    ]
    i = 0
    for h, c, k, rep in cfg:
        for _ in range(rep):
            i += 1
            # 'same' padding modeled by padding the input by r-1
            ls.append(ConvLayer(f"conv{i}", h + 2, h + 2, c, k, 3, 3, 1))
    ls.append(fc("fc6", 512 * 7 * 7, 4096))
    ls.append(fc("fc7", 4096, 4096))
    ls.append(fc("fc8", 4096, 1000))
    return Workload("vgg16", tuple(ls))


def _resnet_stem() -> list[ConvLayer]:
    return [ConvLayer("conv1", 230, 230, 3, 64, 7, 7, 2)]


def resnet34() -> Workload:
    ls = _resnet_stem()
    stages = [(3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7)]
    cin = 64
    for si, (nb, ch, fm) in enumerate(stages):
        for b in range(nb):
            stride = 2 if (b == 0 and si > 0) else 1
            h_in = fm * stride
            ls.append(ConvLayer(f"s{si}b{b}a", h_in + 2, h_in + 2, cin, ch,
                                3, 3, stride))
            ls.append(ConvLayer(f"s{si}b{b}b", fm + 2, fm + 2, ch, ch, 3, 3, 1))
            if stride != 1 or cin != ch:
                ls.append(ConvLayer(f"s{si}b{b}ds", h_in, h_in, cin, ch,
                                    1, 1, stride))
            cin = ch
    ls.append(fc("fc", 512, 1000))
    return Workload("resnet34", tuple(ls))


def resnet50() -> Workload:
    ls = _resnet_stem()
    stages = [(3, 64, 56), (4, 128, 28), (6, 256, 14), (3, 512, 7)]
    cin = 64
    for si, (nb, ch, fm) in enumerate(stages):
        cout = ch * 4
        for b in range(nb):
            stride = 2 if (b == 0 and si > 0) else 1
            h_in = fm * stride
            ls.append(ConvLayer(f"s{si}b{b}a", h_in, h_in, cin, ch,
                                1, 1, stride))
            ls.append(ConvLayer(f"s{si}b{b}b", fm + 2, fm + 2, ch, ch, 3, 3, 1))
            ls.append(ConvLayer(f"s{si}b{b}c", fm, fm, ch, cout, 1, 1, 1))
            if stride != 1 or cin != cout:
                ls.append(ConvLayer(f"s{si}b{b}ds", h_in, h_in, cin, cout,
                                    1, 1, stride))
            cin = cout
    ls.append(fc("fc", 2048, 1000))
    return Workload("resnet50", tuple(ls))


WORKLOADS = {
    "vgg16": vgg16,
    "resnet34": resnet34,
    "resnet50": resnet50,
}


def get_workload(name: str) -> Workload:
    return WORKLOADS[name]()
