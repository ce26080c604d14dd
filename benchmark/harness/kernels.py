"""Device kernels filed by name (``chip_smoke.kernel_group``'s names,
frozen here): the port's two hand-written kernels, cuBLAS GEMMs
(cuBLASLt names its Hopper GEMMs ``nvjet_*``), the top-k sorts, the
optimizer's foreach kernels, and the rest."""


def kernel_group(name: str) -> str:
    if "mtn_attention_" in name:
        return "attention (csrc)"
    if "ffn_" in name:
        return "ffn (csrc)"
    if any(s in name for s in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "sort" in name.lower() or "radix" in name.lower():
        return "sort (top-k)"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach)"
    return "other"


def by_group(ops) -> dict:
    """Seconds by group of ``[name, seconds]`` pairs."""
    out = {}
    for name, s in ops:
        g = kernel_group(name)
        out[g] = out.get(g, 0.0) + s
    return out
