"""Shared CLI plumbing: the flag surface of ``mtn_tpu/cli/common.py`` plus
``--device``, and the parallel set-up of a run (``--multihost``,
``--mesh-data``, ``--mesh-model``)."""

from __future__ import annotations

import argparse
import logging

import torch

log = logging.getLogger(__name__)


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


def kernel_launches() -> dict:
    """The hand-written kernels' launches so far in this process, by
    kernel (0 on the CPU, where their plain versions run)."""
    from mtn_tpu_torch.ops import attention_kernel, ffn_kernel, norm_kernel
    return {"attention": attention_kernel.KERNEL.launches,
            "ffn": ffn_kernel.KERNEL.launches,
            "norm": norm_kernel.KERNEL.launches}


def add_device_args(parser: argparse.ArgumentParser):
    """The JAX CLI's device knobs, with the same names and defaults."""
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; 'cpu' runs the kernels' plain "
                             "versions on the CPU")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="compute dtype")
    parser.add_argument("--mesh-data", default=-1, type=int,
                        help="data-parallel mesh axis size (-1: all ranks)")
    parser.add_argument("--mesh-model", default=1, type=int,
                        help="tensor-parallel mesh axis size")
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
                        help="trace output directory: the train CLI "
                             "writes a torch.profiler trace_<pid>.json, "
                             "cli.generate its decode pass's host and "
                             "device spans as decode_spans_<pid>.json "
                             "(Chrome trace format); cli.rank accepts and "
                             "ignores it")
    parser.add_argument("--nan-checks", default=0, type=int,
                        help="raise on a non-finite loss or gradient (one "
                             "host sync per train step)")


def make_mesh_from_args(args, batch_size: int = 0, device_type=None):
    """(mesh, shardings) of the mesh flags over the world's ranks, or
    (None, None) for one device, as ``mtn_tpu``'s. The mesh takes every
    rank, so where ``batch_size`` does not divide over the data axis this
    raises (JAX fits the data axis to the batch on fewer devices)."""
    from mtn_tpu_torch.parallel import Shardings, make_mesh
    from mtn_tpu_torch.parallel.mesh import world_size
    n = world_size()
    if args.mesh_model <= 1 and (args.mesh_data in (-1, 1) or n == 1):
        if n == 1 or args.mesh_data == 1:
            return None, None  # single device: skip mesh machinery
    model = max(args.mesh_model, 1)
    data = args.mesh_data
    if data == -1:
        if n % model:
            raise AssertionError(f"{n} devices not divisible by "
                                 f"model={model}")
        data = n // model
    if batch_size > 0 and batch_size % data:
        raise ValueError(f"the batch size {batch_size} does not divide over "
                         f"{data} data-parallel ranks")
    mesh = make_mesh(data=data, model=model, device_type=device_type)
    return mesh, Shardings(mesh)


def init_parallel(args, batch_size: int = 0):
    """This run's device and shardings: ``--device``, or under
    ``--multihost`` this rank's device once the process group is joined;
    then the mesh of :func:`make_mesh_from_args` (shardings None on one
    device)."""
    device = resolve_device(args.device)
    if getattr(args, "multihost", ""):
        from mtn_tpu_torch.parallel.multihost import initialize_from_flag
        device = initialize_from_flag(args.multihost, device=str(device))
    mesh, shardings = make_mesh_from_args(args, batch_size, device.type)
    if mesh is not None:
        log.info("running under mesh %s", dict(zip(
            mesh.mesh_dim_names, mesh.shape)))
    return device, shardings


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
