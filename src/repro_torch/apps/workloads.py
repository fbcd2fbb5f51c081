"""PyTorch implementations of the paper's benchmark programs (§7).

Micro-benchmarks (Great Computer Language Shootout, Table 3), realistic
benchmarks (Computer Language Benchmark Game, Table 4), and the
application benchmarks of §7.3 (N-queens, sudoku, face detection, virus
scan, the image combiner).  Each is registered as a ``RemoteableMethod``
with the same asymptotic complexity as the original; the Java
object-oriented micro-benchmarks (methcall / objinst / binarytrees) map
to loops of the same complexity.

Every function runs on ``device``: the card unless the caller names
another (raising where there is none).  A loop of the reference's
``fori_loop`` is a Python loop of eager ops here, so on the card the
iterative programs are bound by kernel launches, not by arithmetic.
Results keep the reference's dtypes (int32 counts, float32 values), so
the bytes a result carries back (``pytree_bytes``) are the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import RemoteableMethod, split_batch, split_range
from repro_torch.models.context import resolve_device

Device = Optional[Union[str, torch.device]]

_LCG = 1103515245          # the reference's hash multiplier


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def _work_loop(iters: int, size: int = 64, device: Device = None):
    """Compute-bound inner loop: ``iters`` matvec steps,
    ``acc = tanh(m @ acc + 1e-6 * i)``; the float32 sum of the result."""
    dev = resolve_device(device)
    acc = torch.full((size,), 0.5, dtype=torch.float32, device=dev)
    m = torch.eye(size, dtype=torch.float32, device=dev) * 0.99 + 0.01
    # float32(1e-6) * float32(i), as the reference's weak-typed product
    bias = (torch.arange(int(iters), dtype=torch.float32, device=dev)
            * torch.tensor(1e-6, dtype=torch.float32))
    for i in range(int(iters)):
        acc = torch.tanh(torch.addmv(bias[i], m, acc))
    return acc.sum()


def _i32(x: torch.Tensor) -> torch.Tensor:
    """A count as int32, the reference's dtype (torch sums ints to int64)."""
    return x.to(torch.int32)


# --------------------------------------------------------------------------- #
# Table 3 micro-benchmarks (complexity-faithful)
# --------------------------------------------------------------------------- #
def fib_iters(n) -> int:
    """``fibonacci``'s iteration count: float32 ``1.618 ** clip(n, 0, 30)``
    truncated, as in the reference.  numpy's float32 power is within an ulp
    of exact; XLA's CPU power, which the reference runs, lands 4 ulps
    higher at n = 26 (271295 iterations against 271294) and agrees at every
    other n, all of Table 3's sizes (6-24) included."""
    return int(np.float32(1.618) ** np.float32(min(max(int(n), 0), 30)))


def fibonacci(n, device: Device = None):
    """O(2^n): cost of the naive recursion, evaluated iteratively
    (:func:`fib_iters` steps of the work loop)."""
    return _work_loop(fib_iters(n), device=device)


def hash_bench(n, device: Device = None):
    """O(n^2 log n): repeated sorting of n keys, n times.  The reference's
    int32 product wraps; ``% 2**16`` of the int64 product is the same key,
    since 2**16 divides 2**32."""
    dev = resolve_device(device)
    keys = _i32(torch.arange(int(n), device=dev) * _LCG % 2 ** 16)
    for i in range(int(n)):
        keys = torch.sort(keys + i).values
    return _i32(keys.sum())


def hash2(n, device: Device = None):
    """O(n log n): one sort of n * 100 keys."""
    dev = resolve_device(device)
    keys = _i32(torch.arange(int(n) * 100, device=dev) * _LCG % 2 ** 16)
    return torch.sort(keys).values[-1]


def matrix(n, device: Device = None):
    """O(n): chain of fixed-size matmuls, n links."""
    return _work_loop(n, size=30, device=device)


def methcall(n, device: Device = None):
    """O(n): n dependent scalar ops (dynamic-dispatch analogue)."""
    return _work_loop(n, size=8, device=device)


def nestedloop(n, device: Device = None):
    """O(n^6): six nested loops of range n."""
    return _work_loop(min(max(int(n), 0), 12) ** 6, size=8, device=device)


def objinst(n, device: Device = None):
    """O(n): n small allocations+init (object instantiation analogue)."""
    return _work_loop(n, size=8, device=device)


def sieve(n, device: Device = None):
    """O(n): sieve of Eratosthenes over n*1000 integers (vectorized)."""
    dev = resolve_device(device)
    m = int(n) * 1000
    nums = torch.arange(2, m + 2, dtype=torch.int32, device=dev)
    is_prime = torch.ones_like(nums, dtype=torch.bool)
    for p in (2, 3, 5, 7, 11, 13):
        is_prime &= (nums <= p) | (nums % p != 0)
    return _i32(is_prime.sum())


# --------------------------------------------------------------------------- #
# Table 4 realistic benchmarks
# --------------------------------------------------------------------------- #
def binarytrees(n, device: Device = None):
    """O(2^n) allocations: tree build/teardown analogue."""
    return _work_loop(2 ** min(max(int(n), 0), 22), size=8, device=device)


def knucleotide(n, device: Device = None):
    """k-mer counting over a 4-letter sequence of length n*10000 (the
    reference's wrapping int32 product gives the same residues mod 4)."""
    dev = resolve_device(device)
    m = int(n) * 10_000
    seq = torch.arange(m, device=dev) * _LCG % 4
    k4 = seq[:-3] * 64 + seq[1:-2] * 16 + seq[2:-1] * 4 + seq[3:]
    return _i32(torch.bincount(k4, minlength=256).max())


def mandelbrot(n, device: Device = None):
    """Mandelbrot escape iteration on an (n x n) grid in complex64, 50
    steps; points that escape overflow to inf / nan and stop counting."""
    dev = resolve_device(device)
    xs = torch.linspace(-2.0, 0.5, int(n), dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.25, 1.25, int(n), dtype=torch.float32, device=dev)
    c = torch.complex(xs[None, :].expand(int(n), -1),
                      ys[:, None].expand(-1, int(n)))
    z = torch.zeros_like(c)
    k = torch.zeros(c.shape, dtype=torch.int32, device=dev)
    for _ in range(50):
        z = z * z + c
        k = k + (torch.abs(z) < 2.0)
    return _i32(k.sum())


def nbody(n, device: Device = None):
    """n simulation steps of a 16-body system."""
    dev = resolve_device(device)
    a = torch.arange(16.0, dtype=torch.float32, device=dev)
    p = torch.stack([torch.sin(a), torch.cos(a), torch.sin(a * 2)], 1)
    v = torch.zeros_like(p)
    for _ in range(int(n)):
        d = p[:, None] - p[None, :]
        r2 = (d ** 2).sum(-1) + 1e-3
        f = (d / (r2 ** 1.5)[..., None]).sum(1)
        v = v - 0.001 * f
        p = p + 0.001 * v
    return (p ** 2).sum()


def spectralnorm(n, device: Device = None):
    """Power iteration on the (n x n) infinite-matrix A of the benchmark."""
    dev = resolve_device(device)
    i = torch.arange(int(n), dtype=torch.float32, device=dev)
    s = i[:, None] + i[None, :]
    a = 1.0 / (s * (s + 1) / 2 + i[:, None] + 1)
    u = torch.ones(int(n), dtype=torch.float32, device=dev)
    for _ in range(10):
        v = a.T @ (a @ u)
        u = v / torch.linalg.norm(v)
    return torch.sqrt(u @ (a.T @ (a @ u)) / (u @ u))


# --------------------------------------------------------------------------- #
# Application benchmarks (§7.3)
# --------------------------------------------------------------------------- #
def nqueens(n, lo, hi, device: Device = None):
    """Count N-queens solutions over candidate range [lo, hi).

    The paper's reduced brute force (one queen per column, n^n candidates:
    candidate c puts column i's queen on row ``(c // n**i) % n``); the
    range split across clones mirrors 'allocating different regions of the
    board to different clones'.  A candidate is a solution when its rows,
    its ``row + column`` diagonals and its ``row - column`` diagonals are
    each n distinct values, tested as one-hot bitmasks whose sum equals
    their bitwise or: the reference's pairwise test, in n steps per
    candidate in place of n(n-1)/2.  Candidates go in chunks of the
    reference's 2**14 on the CPU and 2**22 on the card (the count does
    not depend on it; fewer, larger chunks mean fewer launches).
    """
    dev = resolve_device(device)
    n, lo, hi = int(n), int(lo), int(hi)
    chunk = 1 << 22 if dev.type == "cuda" else 1 << 14
    end = lo + max(1, -(-(hi - lo) // chunk)) * chunk
    # candidate ids in int32 where they fit (the reference's dtype)
    itype = torch.int32 if end <= 2 ** 31 else torch.int64
    count = torch.zeros((), dtype=torch.int64, device=dev)
    one = torch.ones(chunk, dtype=torch.int32, device=dev)
    for start in range(lo, end, chunk):
        rest = torch.arange(start, start + chunk, dtype=itype, device=dev)
        ok = rest < hi
        sums = [torch.zeros(chunk, dtype=torch.int32, device=dev)
                for _ in range(3)]
        ors = [torch.zeros(chunk, dtype=torch.int32, device=dev)
               for _ in range(3)]
        for i in range(n):
            quot = torch.div(rest, n, rounding_mode="floor")
            row = (rest - quot * n).to(torch.int32)
            rest = quot
            for s, o, v in zip(sums, ors, (row, row + i, row + (n - i))):
                bit = torch.bitwise_left_shift(one, v)
                s += bit
                o |= bit
        for s, o in zip(sums, ors):
            ok &= s == o
        count += ok.sum()
    return _i32(count)


def sudoku(puzzle, device: Device = None):
    """Constraint-propagation solver (singles elimination to fixpoint, 64
    rounds).  Returns the int32 grid and whether every cell is filled."""
    dev = resolve_device(device)
    grid = torch.as_tensor(puzzle, device=dev).to(torch.int32)  # 0 = empty
    r = torch.arange(9, device=dev)
    boxes = (r[:, None] // 3) * 3 + r[None, :] // 3
    flat_boxes = boxes.reshape(-1)

    def allowed_mask(g):
        onehot = F.one_hot(g.long(), 10)[..., 1:].to(torch.int32)  # (9,9,9)
        row_used = onehot.sum(1)
        col_used = onehot.sum(0)
        box_used = torch.zeros((9, 9), dtype=torch.int32, device=dev)
        box_used.index_add_(0, flat_boxes, onehot.reshape(81, 9))
        cand = (row_used[:, None, :] == 0) & (col_used[None, :, :] == 0) \
            & (box_used[boxes] == 0)
        return cand & (g[..., None] == 0)

    g = grid
    for _ in range(64):
        cand = allowed_mask(g)
        single = (cand.sum(-1) == 1) & (g == 0)
        digit = _i32(cand.to(torch.int8).argmax(-1) + 1)
        g = torch.where(single, digit, g)
    return g, (g > 0).all()


# logit(0.7), compared in float32: sigmoid is increasing, so heat > 0.7 is
# x > this up to rounding at the threshold, and a count is then a
# comparison of the convolution's output alone
_FACE_LOGIT = math.log(0.7 / 0.3)


def face_weights():
    """The detector's two 3 x 3 filters in the reference's HWIO layout,
    (3, 3, 1, 8) and (3, 3, 8, 1), standard normal x 0.3 from a CPU
    ``torch.Generator`` seeded 0, so every device gets the same filters
    (the reference draws from ``jax.random.PRNGKey(0)``: other values,
    same law)."""
    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn((3, 3, 1, 8), generator=gen) * 0.3
    w2 = torch.randn((3, 3, 8, 1), generator=gen) * 0.3
    return w1.numpy(), w2.numpy()


def make_face_detector(device: Device = None, weights=None):
    """Tiny convnet 'face detector': ``detect(images) -> counts``.

    ``weights`` is the pair (w1, w2) in the reference's HWIO layout, as
    numpy arrays: the reference's own filters carried across, or by
    default :func:`face_weights`.  Layers: a 3 x 3 "SAME" convolution to 8
    channels, ReLU, a 3 x 3 stride-2 "SAME" convolution to 1 channel (XLA
    pads 64 -> 32 by 0 before and 1 after), sigmoid, and a count of pixels
    whose heat is over 0.7.  Both convolutions are sums of shifted
    products in a fixed order of elementwise float32 ops, so a count is
    the same on the CPU and on the card and whatever batch split a clone
    gets (a library convolution picks its algorithm, and so its rounding,
    per device and batch size; on the card no TF32 is involved).
    ``detect.heat(images)`` gives the (N, 32, 32) heat map.
    """
    dev = resolve_device(device)
    w1, w2 = face_weights() if weights is None else weights
    w1, w2 = (torch.tensor(np.array(w, np.float32), device=dev)
              for w in (w1, w2))
    taps1 = [(dy, dx, w1[dy, dx, 0][None, :, None, None])
             for dy in range(3) for dx in range(3)]
    taps2 = [(dy, dx, c, w2[dy, dx, c, 0])
             for dy in range(3) for dx in range(3) for c in range(8)]

    def logits(images):                              # (N, 64, 64)
        x = torch.as_tensor(images, device=dev).to(torch.float32)
        h, w = x.shape[1:]
        xp = F.pad(x, (1, 1, 1, 1))[:, None]         # stride 1: 1 each side
        y = None
        for dy, dx, wt in taps1:
            term = xp[:, :, dy:dy + h, dx:dx + w] * wt
            y = term if y is None else y + term
        y = F.pad(torch.relu(y), (0, 1, 0, 1))       # stride 2: 0 / 1
        z = None
        for dy, dx, c, wt in taps2:
            term = y[:, c, dy:dy + h:2, dx:dx + w:2] * wt
            z = term if z is None else z + term
        return z                                     # (N, 32, 32)

    def detect(images):
        return _i32((logits(images) > _FACE_LOGIT).sum(dim=(1, 2)))

    detect.heat = lambda images: torch.sigmoid(logits(images))
    return detect


def make_virus_scanner(n_sigs: int = 64, sig_len: int = 8,
                       device: Device = None):
    """Multi-pattern scanner: count signature hits across files.  The
    signatures are the reference's (``np.random.default_rng(0)``); every
    file's windows are compared at once, one window position at a time,
    so the largest temporary is a (files, windows, signatures) bool."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    sigs = torch.as_tensor(rng.integers(0, 256, (n_sigs, sig_len)),
                           device=dev).to(torch.int32)

    def scan(files):                                 # (n_files, file_len)
        f = torch.as_tensor(files, device=dev)
        p = f.shape[1] - sig_len + 1
        eq = None
        for i in range(sig_len):
            hit = f[:, i:i + p, None] == sigs[None, None, :, i]
            eq = hit if eq is None else eq & hit
        return _i32(eq.sum())

    return scan


def image_combiner(img1, img2, device: Device = None):
    """Paper §7.3: naive side-by-side combine (big allocation)."""
    dev = resolve_device(device)
    img1 = torch.as_tensor(img1, device=dev)
    img2 = torch.as_tensor(img2, device=dev)
    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]
    canvas = torch.zeros((h, w), dtype=img1.dtype, device=dev)
    canvas[:img1.shape[0], :img1.shape[1]] = img1
    canvas[:img2.shape[0], img1.shape[1]:] = img2
    return canvas


# --------------------------------------------------------------------------- #
# RemoteableMethod registry for the benchmarks
# --------------------------------------------------------------------------- #
def _bound(fn, device: Device):
    dev = resolve_device(device)
    return lambda *a: fn(*a, device=dev)


def micro_methods(device: Device = None):
    mk = lambda name, fn: RemoteableMethod(name, _bound(fn, device),
                                           size_fn=lambda n: n,
                                           static_args=(0,))
    return {
        "fibonacci": mk("fibonacci", fibonacci),
        "hash": mk("hash", hash_bench),
        "hash2": mk("hash2", hash2),
        "matrix": mk("matrix", matrix),
        "methcall": mk("methcall", methcall),
        "nestedloop": mk("nestedloop", nestedloop),
        "objinst": mk("objinst", objinst),
        "sieve": mk("sieve", sieve),
    }


MICRO_COMPLEXITY = {
    "fibonacci": "O(2^n)", "hash": "O(n^2 log n)", "hash2": "O(n log n)",
    "matrix": "O(n)", "methcall": "O(n)", "nestedloop": "O(n^6)",
    "objinst": "O(n)", "sieve": "O(n)",
}


def realistic_methods(device: Device = None):
    mk = lambda name, fn: RemoteableMethod(name, _bound(fn, device),
                                           size_fn=lambda n: n,
                                           static_args=(0,))
    return {
        "binarytrees": mk("binarytrees", binarytrees),
        "knucleotide": mk("knucleotide", knucleotide),
        "mandelbrot": mk("mandelbrot", mandelbrot),
        "nbody": mk("nbody", nbody),
        "spectralnorm": mk("spectralnorm", spectralnorm),
    }


def nqueens_method(n: int = 8, device: Device = None):
    dev = resolve_device(device)

    def fn(lo, hi):
        return nqueens(n, lo, hi, device=dev)

    def split(args, k):
        lo, hi = args
        return split_range(int(lo), int(hi), k)

    return RemoteableMethod("nqueens", fn, size_fn=lambda lo, hi: hi - lo,
                            split_fn=split, static_args=(0, 1),
                            merge_fn=lambda vs: sum(int(v) for v in vs))


def face_detection_method(device: Device = None, weights=None):
    detect = make_face_detector(device, weights)
    return RemoteableMethod(
        "face_detection", detect, size_fn=lambda imgs: imgs.shape[0],
        split_fn=lambda args, k: split_batch(args, k),
        merge_fn=lambda vs: torch.cat(list(vs)))


def virus_scan_method(device: Device = None):
    scan = make_virus_scanner(device=device)
    return RemoteableMethod(
        "virus_scan", scan, size_fn=lambda files: files.numel(),
        split_fn=lambda args, k: split_batch(args, k),
        merge_fn=lambda vs: sum(int(v) for v in vs))


def image_combiner_method(device: Device = None):
    return RemoteableMethod(
        "image_combiner", _bound(image_combiner, device),
        size_fn=lambda a, b: a.numel() + b.numel(),
        mem_fn=lambda a, b: 4 * max(a.shape[0], b.shape[0])
        * (a.shape[1] + b.shape[1]) * 16)   # 16x overhead: naive bitmap ops
