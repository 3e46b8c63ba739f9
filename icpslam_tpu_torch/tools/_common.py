"""What the tools share (the JAX tools copy these into each file): the
runner as a subprocess, the card's name and power limit, the device
check, free ports and the ``RESULT`` lines of worker processes."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"
RUNNER = "icpslam_tpu_torch.io.runner"


def artifact_path(name: str) -> str:
    """The default ``--out`` of a tool: ``icpslam_tpu_torch/artifacts/<name>``
    (never the JAX package's ``artifacts/``)."""
    return str(ARTIFACTS / name)


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card, which fails without one; "
                    "the CPU runs only with --device cpu)")


def check_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    exits with an error instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: torch.cuda.is_available() is False; "
                         "pass --device cpu to run on the CPU")
    return dev


def card(device) -> dict:
    """The device a run used: on CUDA the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (and how many cards it lists), else ``{"device": "cpu"}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu"}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    name, limit = (s.strip() for s in lines[dev.index or 0].rsplit(",", 1))
    return {"device": str(dev), "name": name, "power_limit": limit, "cards": len(lines)}


def run_runner(args: list, timeout: float = 3000.0) -> dict:
    """Run the port's runner CLI in a subprocess; its summary JSON (the
    last ``{``-line of its stdout) with the invocation's wall seconds."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", RUNNER] + list(args),
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"runner failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    out["_invocation_wall_s"] = round(time.time() - t0, 1)
    return out


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def result_line(out: str) -> Optional[dict]:
    """The first ``RESULT {...}`` line of a worker's output, parsed."""
    lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
    return json.loads(lines[0][len("RESULT "):]) if lines else None


def write_artifact(path: str, artifact: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, by the runner's names."""
    from icpslam_tpu_torch.io.runner import KERNELS

    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    from icpslam_tpu_torch.io.runner import KERNELS

    for fn in KERNELS.values():
        fn.launches = 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
