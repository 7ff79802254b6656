"""Parameter counts of an ``nn.Module`` (port of
``rot_mvgaze_tpu/utils/summary.py``)."""

from __future__ import annotations

from torch import nn


def count_parameters(module: nn.Module) -> int:
    """Parameters of ``module``, each shared tensor counted once."""
    return sum(p.numel() for p in module.parameters())


def parameter_table(module: nn.Module, max_depth: int = 1) -> str:
    """Parameter counts by submodule, grouped by the first ``max_depth``
    components of each parameter's dotted name."""
    groups: dict = {}
    for name, p in module.named_parameters():
        label = ".".join(name.split(".")[:max_depth])
        groups[label] = groups.get(label, 0) + p.numel()
    lines = ["=" * 52, f"{'Module':<36}{'Params':>16}", "-" * 52]
    lines += [f"{label:<36}{n:>16,}" for label, n in sorted(groups.items())]
    lines += ["-" * 52, f"{'Total':<36}{sum(groups.values()):>16,}", "=" * 52]
    return "\n".join(lines)
