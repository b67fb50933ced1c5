"""The 3x3x3 convolutions' least time over their device time while
scoring.  The least time is the larger of operations over the peak rate
and bytes (each input and output once) over the memory bandwidth, both
counted from the shapes each conv module is called with; the device
time is that of everything launched inside the benchmark's ranges around
the modules that hold a 3x3x3 conv weight, their GroupNorm and
activation with them, whatever kernel does the work."""

from portbench.work import conv3d_least_s


def read(run):
    if run.traffic["entry"] != "score":
        return None
    device_s = run.trace.device_s_in("pb.conv3d")
    if not device_s or not run.ranges.conv_flops:
        return None
    least = conv3d_least_s(run.ranges.conv_flops, run.ranges.conv_bytes,
                           run.peak_flops, run.peak_bytes_per_s)
    return 100.0 * least / device_s
