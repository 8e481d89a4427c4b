"""k2_roofline_pct.infer: the decoder's resblock stages (K2: three
ResBlock1 of kernels 3, 7, 11 and dilations 1, 3, 5, 18 convolutions of
C x C a level) against their roofline, in %.

The least time of every stage the window ran is the larger of its work,
2 C^2 T (6 sum k) a stream, over the card's dense TF32 peak and its bytes
(the input and the output once, fp32, and the 18 kernels' weights and
biases once) over its HBM bandwidth; the share is that least time over
the device time of the kernels named in KERNELS, read from the trace.
The work and the bytes are formulas at the cell's shapes, whatever
implements them."""

from math import prod

from rvcbench.lib.peaks import peak

KERNELS = ("conv_kernel",)     # resblock.cu's stage kernel


def stage_work(C: int, T: int, ks, N: int = 1) -> int:
    return 2 * C * C * T * 6 * sum(ks) * N


def stage_bytes(C: int, T: int, ks, N: int = 1) -> int:
    io = 2 * N * C * T * 4
    weights = sum(6 * C * C * k + 6 * C for k in ks) * 4
    return io + weights


def least_seconds(model: dict, frames: int, N: int) -> float:
    ups, C0 = model["upsample_rates"], model["upsample_initial_channel"]
    ks = model["resblock_kernel_sizes"]
    total = 0.0
    for i in range(len(ups)):
        C, T = C0 // 2 ** (i + 1), frames * prod(ups[: i + 1])
        total += max(stage_work(C, T, ks, N) / peak("tf32_flops"),
                     stage_bytes(C, T, ks, N) / peak("hbm_bytes"))
    return total


def read(rec):
    tr, calls = rec.get("trace"), rec.get("decoder_calls")
    if not tr or not calls:
        return None
    busy = sum(s for name, s in tr["kernels"].items()
               if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    model = rec["cfg"]["model"]
    least = sum(c["calls"] * least_seconds(model, c["frames"], c["streams"])
                for c in calls)
    return 100.0 * least / busy
