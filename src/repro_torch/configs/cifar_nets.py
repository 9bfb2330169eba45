"""The paper's own CIFAR-10 demonstration networks (Fig. 11 topologies).
Port of ``repro.configs.cifar_nets``; the policies name the port's
``kernel`` backend (the hand-written CUDA kernel, its plain version on
CPU tensors) where the reference names ``bpbs``.

Network A: 4-b activations/weights, ADC readout.  Paper: 92.4% (vs 92.7%
ideal), 105.2 uJ/image, 23 fps.
Network B: 1-b activations/weights (BNN), ABN readout.  Paper: 89.3% (vs
89.8% ideal), 5.31 uJ/image, 176 fps.
"""
from __future__ import annotations

import dataclasses

from repro_torch.accel import ExecSpec, PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class CnnLayer:
    kind: str            # conv | fc
    cin: int
    cout: int
    pool: bool = False   # 2x2 max pool after activation


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    name: str
    layers: tuple
    ba: int
    bx: int
    readout: str          # adc | abn
    policy: PrecisionPolicy
    image_hw: int = 32
    n_classes: int = 10

    def reduced(self) -> "CnnConfig":
        """Small same-topology variant for CPU tests: channels are capped
        and FC fan-ins recomputed from the pooled spatial size."""
        out = []
        spatial = self.image_hw
        prev_c = None
        for l in self.layers:
            if l.kind == "conv":
                cin = 3 if prev_c is None else prev_c
                cout = min(l.cout, 32)
                if l.pool:
                    spatial //= 2
            else:
                cin = (spatial * spatial * prev_c) if out and out[-1].kind == "conv" \
                    else min(l.cin, 64) if prev_c is None else prev_c
                cout = min(l.cout, 64) if l.cout != self.n_classes \
                    else self.n_classes
            out.append(dataclasses.replace(l, cin=cin, cout=cout))
            prev_c = cout
        return dataclasses.replace(self, layers=tuple(out))


NETWORK_A = CnnConfig(
    name="cifar-net-a",
    layers=(
        CnnLayer("conv", 3, 128), CnnLayer("conv", 128, 128, pool=True),
        CnnLayer("conv", 128, 256), CnnLayer("conv", 256, 256, pool=True),
        CnnLayer("conv", 256, 256), CnnLayer("conv", 256, 256, pool=True),
        CnnLayer("fc", 256 * 4 * 4, 1024), CnnLayer("fc", 1024, 1024),
        CnnLayer("fc", 1024, 10),
    ),
    ba=4, bx=4, readout="adc",
    policy=PrecisionPolicy.uniform(ExecSpec(backend="kernel", ba=4, bx=4)),
)

NETWORK_B = CnnConfig(
    name="cifar-net-b",
    layers=(
        CnnLayer("conv", 3, 128), CnnLayer("conv", 128, 128, pool=True),
        CnnLayer("conv", 128, 256), CnnLayer("conv", 256, 256),
        CnnLayer("conv", 256, 256), CnnLayer("conv", 256, 256, pool=True),
        CnnLayer("fc", 256 * 8 * 8, 1024), CnnLayer("fc", 1024, 1024),
        CnnLayer("fc", 1024, 10),
    ),
    ba=1, bx=1, readout="abn",
    policy=PrecisionPolicy.uniform(ExecSpec(backend="kernel", ba=1, bx=1)),
)
