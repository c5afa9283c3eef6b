"""What every experiment driver shares: its command line, the line that
names the device, the TSV it writes, and the card's published rates."""

from __future__ import annotations

import argparse
import platform
import subprocess

import torch

H100_BYTES_PER_S = 3.35e12      # HBM3 (data sheet, SXM)
H100_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores
H100_L2_BYTES = 50e6


def parser(doc: str, out_default: str) -> argparse.ArgumentParser:
    """A driver's argument parser: the output path first (optional),
    then the driver's own positionals, and ``--device``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("out", nargs="?", default=out_default,
                   help="output TSV (default %(default)s)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="'cuda' (the default) measures the card; 'cpu' "
                        "runs the plain versions, for tests")
    return p


def device_line(device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it
    for a CUDA device (raising without a card), or the host for the
    CPU, where no number the driver writes is a device's."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu: %s (plain versions; no card)" % platform.machine()
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "visible")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    index = device.index or 0
    return "card: " + out.stdout.strip().splitlines()[index]


def write_tsv(path: str, header, rows, device) -> None:
    """``rows`` under ``header`` as tab-separated lines, after one
    ``# `` line naming the device."""
    lines = ["# " + device_line(device), "\t".join(header)]
    lines += ["\t".join(str(c) for c in row) for row in rows]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def read_tsv(path: str) -> tuple:
    """(device line, header, rows as dicts) of a driver's TSV."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    header = lines[1].split("\t")
    return lines[0], header, [dict(zip(header, ln.split("\t")))
                              for ln in lines[2:]]


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``ops`` float32 operations."""
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_o = ops / H100_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
