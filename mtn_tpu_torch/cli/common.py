"""Shared CLI plumbing: the flag surface of ``mtn_tpu/cli/common.py`` plus
``--device``, and the refusal of flags whose paths are not ported yet
(each names its ROADMAP item): the multi-device ones."""

from __future__ import annotations

import argparse
import logging

import torch


def add_logging_args(parser: argparse.ArgumentParser):
    parser.add_argument("--verbose", "-v", default=0, type=int,
                        help="verbose level")


def setup_logging(verbose: int):
    logging.basicConfig(
        level=logging.DEBUG if verbose >= 1 else logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s", force=True)


def print_args(args: argparse.Namespace):
    for arg in vars(args):
        print(f"{arg}={getattr(args, arg)}")


def add_device_args(parser: argparse.ArgumentParser):
    """The JAX CLI's device knobs, with the same names and defaults."""
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions on the CPU")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="compute dtype")
    parser.add_argument("--mesh-data", default=-1, type=int,
                        help="data-parallel size; only one device (-1 or "
                             "1) is ported")
    parser.add_argument("--mesh-model", default=1, type=int,
                        help="tensor-parallel size; only 1 is ported")
    parser.add_argument("--feature-transfer", default="",
                        choices=["", "bfloat16", "int8"],
                        help="host->device feature precision (default: the "
                             "compute dtype; int8 ships int8 features and "
                             "f32 row scales, dequantized on the device)")
    parser.add_argument("--length-bucket", default=32, type=int,
                        help="round text lengths up to this multiple")
    parser.add_argument("--feature-bucket", default=32, type=int,
                        help="round video frame counts up to this multiple")
    parser.add_argument("--prefetch", default=2, type=int,
                        help="host-side batch prefetch depth")
    parser.add_argument("--use-pallas-attention", default=0, type=int,
                        help="use the hand-written fused attention kernel "
                             "(csrc/attention.cu)")
    parser.add_argument("--use-pallas-ffn", default=0, type=int,
                        help="use the hand-written fused FFN kernel "
                             "(csrc/ffn.cu)")
    parser.add_argument("--fused-decode-qkv", default=0, type=int,
                        help="fuse decode-time self-attention q/k/v into "
                             "one (D, 3D) product")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="torch.profiler trace output directory (the "
                             "train CLI traces; the decode CLIs accept and "
                             "ignore it, as in mtn_tpu)")
    parser.add_argument("--nan-checks", default=0, type=int,
                        help="raise on a non-finite loss or gradient (one "
                             "host sync per train step)")


def check_unported(args: argparse.Namespace) -> None:
    """Refuse flags whose paths the port does not run yet."""
    refused = []
    if getattr(args, "multihost", ""):
        refused.append("--multihost (ROADMAP: parallel)")
    if args.mesh_data not in (-1, 1) or args.mesh_model != 1:
        refused.append("mesh sizes > 1 (ROADMAP: parallel)")
    if refused:
        raise NotImplementedError("not ported to mtn_tpu_torch yet: "
                                  + ", ".join(refused))


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on; a CUDA device that is not there
    raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device; "
            "mtn_tpu_torch runs on the GPU (pass --device cpu to run the "
            "kernels' plain versions on the CPU)")
    return device
