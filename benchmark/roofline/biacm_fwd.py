"""Kernel #1, BiACM attention's serving forward (``biacm_fwd_kernel``): the
operations and bytes one call needs for a batch of pages of the given real
token counts. Per page of n tokens and each of nh heads: the two streams'
scores (n² dot products of d_t and of d_l) and the two p·v products, 2 FLOPs
a multiply-add; q, k, v and the output of both streams in bf16, read or
written once, and the fp32 key mask. Padding rows and keys are work no page
needs, and are not counted."""

KERNEL = "biacm_fwd_kernel"


def cost(cfg, lengths):
    """(FLOPs, bytes) of one call over pages of ``lengths`` real tokens."""
    nh = cfg["num_attention_heads"]
    d_t = cfg["hidden_size"] // nh
    d = d_t + d_t // cfg["channel_shrink_ratio"]
    flops = sum(4 * nh * n * n * d for n in lengths)
    nbytes = sum(4 * nh * n * d * 2 + 4 * n for n in lengths)
    return flops, nbytes
