"""Kernel #4, rel-bias attention's serving forward (``bias_fwd_kernel``):
the operations and bytes one call needs for a batch of LayoutLMv3 pages of
the given real text rows. A page of n rows attends over P = n + 1 + grid²
positions (its text, then the image's CLS and patches). Per page and each
of nh heads: the scores (P² dot products of d) and the p·v product, 2 FLOPs
a multiply-add; q, k, v and the output in bf16, read or written once, the
page's P × P rows of the fp32 bias, and the fp32 key mask. Padding rows and
keys, and the bias's padding columns, are work no page needs, and are not
counted."""

KERNEL = "bias_fwd_kernel"


def cost(cfg, lengths):
    """(FLOPs, bytes) of one call over pages of ``lengths`` real text
    rows."""
    nh = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // nh
    image = (cfg["input_size"] // cfg["patch_size"]) ** 2 + 1
    positions = [n + image for n in lengths]
    flops = sum(4 * nh * p * p * d for p in positions)
    nbytes = sum(4 * nh * p * d * 2 + nh * p * p * 4 + 4 * p
                 for p in positions)
    return flops, nbytes
