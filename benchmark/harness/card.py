"""The card a run used: its name and memory, and nvidia-smi's readings of its
power limit, clock and temperature around the window."""

from __future__ import annotations

import subprocess

QUERY = "name,power.limit,clocks.sm,temperature.gpu"


def smi(index: int = 0) -> str:
    """nvidia-smi's ``QUERY`` for card ``index``, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", f"--query-gpu={QUERY}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    if out.returncode != 0:
        return f"nvidia-smi failed: {out.stderr.strip()[:200]}"
    return out.stdout.strip()


def describe(device, chips: int, peak_bytes: int) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak_bytes)}
