"""Operations and bytes against a count by hand at a small shape."""

from benchmark.harness import flops

CFG = dict(d_model=4, d_ff=8, vocab_size=10, nb_blocks=1, ft_sizes=[3],
           auto_encoder_ft="query")


def test_products():
    assert flops.linear(2, 3, 5) == 60
    assert flops.attention_core(2, 3, 4) == 96
    # q and o over 2 rows, k and v over 3 rows, the core
    assert flops.mha(2, 3, 4) == 2 * 64 + 2 * 96 + 96


def test_decode_turn_by_hand():
    # query 2, history 3, caption 1, one stream of 5 frames; 1 step of 2
    # beam rows
    enc = 2 * 5 * 3 * 4                        # video encoder
    cross = 2 * (2 * 3 * 16 + 2 * 1 * 16 + 2 * 2 * 16)   # k, v of his/cap/q
    ae = (2 * 2 * 2 * 16 + 2 * 2 * 2 * 16 + 4 * 2 * 2 * 4     # self
          + 2 * 2 * 2 * 16 + 2 * 2 * 5 * 16 + 4 * 2 * 5 * 4   # to video
          + 2 * 2 * 4 * 8 * 2                                 # ffn
          + 2 * 2 * 2 * 16)                                   # ae k, v
    step = (4 * 2 * 16 + 4 * 1 * 4                 # self, 1 position
            + 3 * 2 * 2 * 16 + 4 * (3 + 1 + 2) * 4   # his, cap, query
            + 2 * 2 * 16 + 4 * 2 * 4               # to the auto-encoder
            + 2 * 2 * 4 * 8)                       # ffn
    gen = 2 * 4 * 10
    want = enc + cross + ae + 2 * (step + gen)
    assert flops.decode_turn(CFG, 2, 3, 1, [5], 1, 2) == want


def test_kernels_by_hand():
    ops, nbytes = flops.attention_kernel(2, 3, 4, 5, 8, 2)
    assert ops == 4 * 2 * 3 * 4 * 5 * 8
    # q and out (2·3·4·8 each), k and v (2·3·5·8 each) in bf16, the mask
    assert nbytes == 2 * (2 * 2 * 3 * 4 * 8 + 2 * 2 * 3 * 5 * 8) + 2 * 5
    ops, nbytes = flops.ffn_kernel(3, 4, 8, 2)
    assert ops == 2 * (2 * 3 * 4 * 8)
    assert nbytes == 2 * (3 * 4 + 4 * 8 + 8 + 8 * 4 + 4 + 3 * 4)
