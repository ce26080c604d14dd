"""Operations and bytes of a language-model decode cell
(``architecture: kimi_vl``), counted from shapes and from the routing.

Operations follow :mod:`benchmark.harness.flops`' rules: a product of an
(m, k) and a (k, n) matrix is ``2·m·k·n``, only products count, padding
counts as no work. A prompt of ``P`` real tokens (its frames through the
projectors, then its text) runs every layer's projections and its causal
attention (the decompressed form: ``P·(P+1)/2`` query-key pairs), and
each real token's MLP: the dense one in the first layers, else its
``num_experts_per_tok`` routed and ``n_shared_experts`` shared experts
and the router; the last layer's prompt work is its latent projection
alone, which is all its cache needs. A decode step of one beam row at
answer position ``l`` runs the absorbed attention over ``P + l + 1``
latents and every layer's MLP, then the head.

The routed experts' bytes in a decode step
(:func:`expert_step_bytes`), what their two grouped GEMMs must move
(each input read once, each output written once): the weights of every
expert the step's own routing touched (gate, up and down:
``3·hidden·moe_intermediate`` elements each), the gathered rows in and
the rows out of both products.
"""

from __future__ import annotations

from typing import Sequence


def linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def _widths(cfg: dict):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    return D, H, dn, dr, dv, cfg["kv_lora_rank"]


def mlp(cfg: dict, rows: int, layer: int) -> int:
    """Layer ``layer``'s MLP over ``rows`` real tokens."""
    D = cfg["hidden_size"]
    if layer < cfg["first_k_dense_replace"]:
        return 3 * linear(rows, D, cfg["intermediate_size"])
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    return 3 * linear(rows, D, cfg["moe_intermediate_size"]) * experts \
        + linear(rows, D, cfg["n_routed_experts"])


def prefill(cfg: dict, P: int, frames: Sequence[int]) -> int:
    """One turn's prompt of ``P`` real tokens, ``frames`` of them per
    feature stream."""
    D, H, dn, dr, dv, r = _widths(cfg)
    p = cfg["projector_hidden_size"]
    n = sum(linear(T, ft, p) + linear(T, p, D)
            for T, ft in zip(frames, cfg["ft_sizes"]))
    pairs = P * (P + 1) // 2
    layers = cfg["num_hidden_layers"]
    for layer in range(layers):
        n += linear(P, D, r + dr)
        if layer == layers - 1:
            break
        n += linear(P, D, H * (dn + dr)) + linear(P, r, H * (dn + dv)) \
            + linear(P, H * dv, D) + 2 * H * (dn + dr) * pairs \
            + 2 * H * dv * pairs + mlp(cfg, P, layer)
    return n


def step(cfg: dict, keys: int) -> int:
    """One beam row's decode step attending ``keys`` latents."""
    D, H, dn, dr, dv, r = _widths(cfg)
    n = linear(1, D, cfg["vocab_size"])
    for layer in range(cfg["num_hidden_layers"]):
        n += linear(1, D, H * (dn + dr)) + linear(1, D, r + dr) \
            + 2 * H * dn * r + 2 * H * (r + dr) * keys + 2 * H * r * keys \
            + 2 * H * r * dv + linear(1, H * dv, D) + mlp(cfg, 1, layer)
    return n


def decode_turn(cfg: dict, P: int, frames: Sequence[int], steps: int,
                beam: int) -> int:
    """One turn's beam decode: its prefill, then ``steps`` positions of
    ``beam`` rows."""
    return prefill(cfg, P, frames) + beam * sum(
        step(cfg, P + l + 1) for l in range(steps))


def expert_step_bytes(cfg: dict, touched: int, rows: int,
                      elem: int = 2) -> int:
    """Bytes one MoE layer's grouped GEMMs move in a step whose routing
    touched ``touched`` experts with ``rows`` (token, expert)
    assignments: the touched experts' weights, the gathered rows in and
    the rows out of the gate/up and the down products."""
    D, Fe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return elem * (touched * 3 * D * Fe + rows * (D + 2 * Fe + Fe + D))
