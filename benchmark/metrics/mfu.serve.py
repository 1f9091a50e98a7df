"""Model FLOP utilization (%) of serving: the matrix-product FLOPs that the
traced window's pages need at their real token counts (the backbone over a
page's tokens, the pair head over the upper triangle of its decoder
positions; ``reference/*.py`` ``forward_flops``), over the window's time
and the card's published bf16 peak (``peaks.json``)."""


def read(run, trace):
    if trace is None or not run["batches"]:
        return None
    import torch

    from benchmark import harness
    from benchmark.reference import decoder

    config = run["config"]
    bb = harness.backbone_config(config)
    ref = harness.reference_module(config["family"])
    d_in = ref.output_width(bb)
    flops = sum(ref.forward_flops(bb, n) + decoder.forward_flops(bb, d_in,
                                                                 n - 1)
                for batch in run["batches"] for n in batch)
    peak = harness.peaks(torch.cuda.get_device_name(0))["bf16_flops_per_s"]
    return 100.0 * flops / (run["window_s"] * peak)
