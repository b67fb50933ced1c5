"""The 3x3x3 convolutions' least time over their device time in the
forward of each training step (see ``conv3d_roofline.score``); the
backward's kernels run outside the forward's ranges and are not
counted."""

from portbench.work import conv3d_least_s


def read(run):
    if not run.traffic.get("train"):
        return None
    device_s = run.trace.device_s_in("pb.conv3d")
    if not device_s or not run.ranges.conv_flops:
        return None
    least = conv3d_least_s(run.ranges.conv_flops, run.ranges.conv_bytes,
                           run.peak_flops, run.peak_bytes_per_s)
    return 100.0 * least / device_s
