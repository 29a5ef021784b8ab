"""Sort or radix-sort the per-bounce ray state?  Each stage timed at the
headline frame's payload, on the card.

Counterpart of `tools/radix_lab.py`.  A bounce of the renderer orders 13
per-ray operands (12 float32 and the pixel id) by a 32-bit coherence key
(`render/renderer.py::coherence_sort`).  An LSD radix sort would do that
in four passes of histogram -> spine -> scatter.  The rows:

  sort14                          stable `torch.sort` of the key as int64,
                                  then 13 gathers (the renderer's sort
                                  until it keyed on int32 and permuted in
                                  one kernel, `kernels/ray_sort.py`)
  sort2+gather                    the same with the key as int32 (sign bit
                                  flipped so that signed order is the
                                  unsigned order): what a 32-bit key buys
  radix_hist+spine_4pass          the histogram kernel (`kernels/radix_hist`)
                                  four times, with the prefix-sum spine
  radix_hist+spine_1read          the same counts from one read of the keys
  radix_4pass_scatter_lowerbound  4 passes x 14 gathers by a fixed
                                  permutation: the least the four scatters
                                  of key and payload could cost

`torch.sort` and indexing stay PyTorch calls, as the JAX tool left its
sort and gathers to XLA.  One JSON line per row, with the card's name and
power limit.

    python -m wavefront_tpu_torch.tools.radix_lab [--n N] [--reps R]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.headline import HEADLINE_RAYS
from wavefront_tpu_torch.kernels.radix_hist import radix_hist
from wavefront_tpu_torch.tools._timing import emit, require_card, time_ms

SEED = 0xDEADBEEF


def rows(n: int = HEADLINE_RAYS, reps: int = 5) -> list:
    """The lab's rows ({"row", "ms", "n"}), measured on the card."""
    rng = np.random.default_rng(SEED)
    key_u32 = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    ops = [torch.as_tensor(rng.random(n, np.float32), device="cuda")
           for _ in range(12)]
    ops.append(torch.arange(n, dtype=torch.int32, device="cuda"))
    perm0 = torch.as_tensor(rng.permutation(n), device="cuda")

    key64 = torch.as_tensor(key_u32.astype(np.int64), device="cuda")
    key_bits = torch.as_tensor(key_u32.view(np.int32), device="cuda")
    key32 = key_bits ^ torch.tensor(-2 ** 31, dtype=torch.int32,
                                    device="cuda")

    def sort_gather(key):
        perm = torch.sort(key, stable=True).indices
        return perm, [o[perm] for o in ops]

    p64, p32 = sort_gather(key64)[0], sort_gather(key32)[0]
    if not torch.equal(p64, p32):
        raise AssertionError("the int32 key orders the rays differently")
    hist = radix_hist(key_bits)
    if not torch.equal(hist, radix_hist(key_bits, one_read=True)) \
            or hist[:, -1].tolist() != [n] * 4:
        raise AssertionError("the radix histograms do not count every key")

    def scatter4():
        state = [key_bits] + ops
        for _ in range(4):
            state = [o[perm0] for o in state]
        return state

    timed = (
        ("sort14", lambda: sort_gather(key64)),
        ("sort2+gather", lambda: sort_gather(key32)),
        ("radix_hist+spine_4pass", lambda: radix_hist(key_bits)),
        ("radix_hist+spine_1read",
         lambda: radix_hist(key_bits, one_read=True)),
        ("radix_4pass_scatter_lowerbound", scatter4),
    )
    return [{"row": name, "ms": time_ms(fn, reps), "n": n}
            for name, fn in timed]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=HEADLINE_RAYS,
                   help="keys and rays (default 1920*1080)")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    require_card()
    emit(rows(args.n, args.reps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
