"""Share (%) of kernel #1's roofline (``csrc/biacm_attention.cu``
``biacm_fwd_kernel``, BiACM attention of the serving forward): the least
time the card could take for the calls of the traced window, from the
operations and bytes each call's pages need (``roofline/biacm_fwd.py``) at
the published peaks, over the calls' device time in the trace."""

def read(run, trace):
    if trace is None:
        return None
    import torch

    from benchmark import harness

    kernel = harness.roofline("biacm_fwd")
    times = trace.op_seconds(kernel.KERNEL)
    if not times or not run["batches"]:
        return None
    card = harness.peaks(torch.cuda.get_device_name(0))
    bb = harness.backbone_config(run["config"])
    layers = bb["num_hidden_layers"]
    bound = 0.0
    for batch in run["batches"]:
        flops, nbytes = kernel.cost(bb, batch)
        bound += layers * max(flops / card["bf16_flops_per_s"],
                              nbytes / card["hbm_bytes_per_s"])
    # a traced call the trace lost takes its share of the bound with it
    bound *= len(times) / (layers * len(run["batches"]))
    return 100.0 * bound / sum(times)
