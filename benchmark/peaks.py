"""The card's published peaks, and its name and power limit.

Peaks by ``torch.cuda.get_device_name()``, from NVIDIA's H100 SXM data
sheet: dense bf16 tensor-core rate (half of the 1,979 TFLOP/s quoted with
sparsity) and HBM3 bandwidth. They hold at the full 700 W power limit; a
card set lower says so through ``power_limit_w``.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.5}
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _card_ids(device) -> set:
    """The ways nvidia-smi may name the card torch calls ``device``: its PCI
    address as ``pci.bus_id`` writes it, and its UUID."""
    import torch

    props = torch.cuda.get_device_properties(device)
    ids = set()
    if hasattr(props, "pci_bus_id"):
        ids.add(f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:{props.pci_device_id:02X}.0")
    if getattr(props, "uuid", None):
        ids.add(f"GPU-{props.uuid}".upper())
    return ids


def power_limit(query: str, ids: set) -> Optional[float]:
    """The power limit in W of the card named by one of ``ids``, from the
    lines of ``nvidia-smi --query-gpu=name,pci.bus_id,uuid,power.limit
    --format=csv,noheader``; None where no line names it. nvidia-smi lists
    every card of the host whatever ``CUDA_VISIBLE_DEVICES`` says, so the
    card is matched by its address, not its place in the list."""
    for line in query.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) < 4 or not {fields[-3].upper(), fields[-2].upper()} & ids:
            continue
        try:
            return float(fields[-1].split()[0])
        except (IndexError, ValueError):
            return None
    return None


def device_info(device) -> Dict[str, Optional[object]]:
    """The card's name as torch gives it and its power limit in W as
    nvidia-smi reads it (None where the query fails)."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,pci.bus_id,uuid,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        limit = power_limit(out.stdout, _card_ids(device))
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": torch.cuda.get_device_name(device), "power_limit_w": limit}
