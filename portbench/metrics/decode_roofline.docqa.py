"""The decode steps' least time over their device time: per step the
larger of each operation's work over the peak rate and its bytes over
the memory bandwidth (``portbench.jamba_work.jamba_ops``; a step is
bound by its bytes, 6.32 GB of weights and caches at Jamba2-Mini's
widths), summed over the window's requests, over the device time of
the decode steps' operations (``portbench.metrics.docqa.decode_ops``)."""

from portbench.metrics.docqa import decode_ops, window_work


def read(run):
    work, requests = window_work(run), decode_ops(run)
    if work is None or not requests:
        return None
    least = sum(w.least_s(run.peak_flops, run.peak_bytes_per_s)
                for w in work if w.phase == "decode")
    device_s = sum(e - s for ops in requests for s, e in ops) / 1e9
    return 100.0 * least / device_s if device_s else None
