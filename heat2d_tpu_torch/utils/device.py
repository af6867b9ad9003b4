"""Device selection and introspection (the detailsGPU analogue,
grad1612_cuda_heat.cu:24-37).

Entry points run on ``cuda`` unless the caller asks for the CPU. With no
card and no such request they raise ``DeviceUnavailableError``, naming
the missing device: a run never carries on silently on the CPU.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


class DeviceUnavailableError(RuntimeError):
    """The requested device (the CUDA card, by default) is not present."""


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` by default; ``cpu`` only when the
    caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "heat2d_tpu_torch runs on a CUDA device, and none is available "
            "(torch.cuda.is_available() is False); pass device='cpu' "
            "(--device cpu) to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailableError(
            f"device {dev} is not supported: use 'cuda' or 'cpu'")
    return dev


def nvidia_smi_query(fields: str = "name,power.limit") -> str | None:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` for the
    first card, or None where nvidia-smi is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_summary(device=None) -> dict:
    """Name, count and power limit of the card (or the CPU's facts)."""
    dev = torch.device("cuda" if device is None else device)
    info = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}
    if dev.type == "cuda" and torch.cuda.is_available():
        smi = nvidia_smi_query("name,power.limit")
        info.update({
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(dev),
            "n_devices": torch.cuda.device_count(),
            "power_limit": smi.split(",")[-1].strip() if smi else None,
            "nvidia_smi": smi,
        })
    else:
        info.update({"platform": "cpu", "device_kind": "cpu",
                     "n_devices": 1, "power_limit": None})
    return info


def print_device_summary(device=None) -> None:
    """``device_summary`` as ``key: value`` lines (the CLI's
    ``--device-info``)."""
    for k, v in device_summary(device).items():
        print(f"{k}: {v}")
