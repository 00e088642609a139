"""The paper's own workloads (VGG-16 / ResNet-34 / ResNet-50) re-exported
as configs for the sweep; see repro_torch.core.workloads."""
from repro_torch.core.workloads import WORKLOADS, get_workload  # noqa: F401
