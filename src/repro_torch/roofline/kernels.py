"""The work of each hand-written kernel of K3 and K4, from its shapes alone.

Each function returns an ``(operations, bytes)`` pair: the operations
that the kernel's function needs (a multiply-add counted as 2) over what
its mask lets through, and the bytes it must move, each operand read once
and each result written once.  Neither counts what the kernel reads
again, its scratch, or a plain version's intermediates (the (S, S)
scores).  ``chip_smoke.py`` turns them into the bounds it prints
(``fa_bound``, ``fa_bwd_bound``, ``ssd_bound``, ``ssd_bwd_bound``); the dry
run (``launch.dryrun``) adds them to a cell's count for each shape-only
call of K3, K4 and their backwards (``roofline.counter``).
"""

from __future__ import annotations

__all__ = ["SSD_CHUNK", "visible_pairs", "flash_attention_work", "flash_attention_bwd_work",
           "ssd_scan_products", "ssd_scan_work", "ssd_scan_bwd_products", "ssd_scan_bwd_work"]

SSD_CHUNK = 64          # K4's own chunk length (kernels/ssd_scan/ops.py's Q)
SSD_SPAN = 4            # chunks a span of K4's saved states


def _spans(s: int, chunk: int) -> int:
    """Spans of K4's saved states: SSD_SPAN chunks each."""
    chunks = -(-s // chunk)
    return -(-chunks // SSD_SPAN)


def visible_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs that causal attention over S positions sees, with
    a local ``window`` (0: none): min(i + 1, window) keys for query i."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention_work(bh: int, bkv: int, s: int, dh: int, bytes_per_el: int,
                         window: int = 0, with_lse: bool = False) -> tuple[float, float]:
    """K3's forward: the two products QK^T and PV over the visible pairs of
    each of the BH q rows (2 Dh operations each); q, k, v read and the
    output written (and the f32 lse where the training launch writes it)."""
    ops = 4.0 * bh * visible_pairs(s, window) * dh
    nbytes = (2 * bh + 2 * bkv) * s * dh * bytes_per_el + (4 * bh * s if with_lse else 0)
    return ops, float(nbytes)


def flash_attention_bwd_work(bh: int, bkv: int, s: int, dh: int, bytes_per_el: int,
                             window: int = 0) -> tuple[float, float]:
    """K3's backward: five products over the visible pairs (QK^T, dO V^T,
    P^T dO, dS K, dS^T Q; 2 Dh operations each, 2.5x the forward's two);
    q, k, v, the output, dO and the f32 lse read, dq, dk, dv written."""
    ops = 10.0 * bh * visible_pairs(s, window) * dh
    nbytes = (4 * bh + 4 * bkv) * s * dh * bytes_per_el + 4 * bh * s
    return ops, float(nbytes)


def ssd_scan_products(b: int, s: int, h: int, p: int, n: int,
                      chunk: int = SSD_CHUNK) -> tuple[float, float]:
    """(product operations, other operations) of K4's chunked form.  Per
    batch row and chunk of q positions, C B^T over its q (q + 1) / 2 lower
    pairs (2 N each; B and C are shared by the heads); per head and chunk,
    the decay L on those pairs (1 each, the other operations), the
    intra-chunk product (2 P each), and the carry-in C h^T and the state
    update (2 q P N each)."""
    products = rest = 0.0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        pairs = q * (q + 1) / 2
        products += b * pairs * 2 * n + b * h * (pairs * 2 * p + 4 * q * p * n)
        rest += b * h * pairs
    return products, rest


def ssd_scan_work(b: int, s: int, h: int, p: int, n: int, with_h0: bool,
                  chunk: int = SSD_CHUNK, with_states: bool = False) -> tuple[float, float]:
    """K4's forward: ``ssd_scan_products``' two summed; the f32 operands x,
    dt, A, B, C read (h0 too, if given) and y and the final state written
    (and the span states where the training launch keeps them)."""
    products, rest = ssd_scan_products(b, s, h, p, n, chunk)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + (2 if with_h0 else 1) * b * h * p * n
                  + (b * h * _spans(s, chunk) * p * n if with_states else 0))
    return products + rest, float(nbytes)


def ssd_scan_bwd_products(b: int, s: int, h: int, p: int, n: int,
                          chunk: int = SSD_CHUNK) -> tuple[float, float]:
    """(product operations, other operations) of K4's backward.  Per batch
    row and chunk C B^T over its q (q + 1) / 2 lower pairs (2 N each); per
    head and chunk on those pairs dy (dt x)^T and M^T dy (2 P each), LD B
    and LD^T C (2 N each) and the decays (3 each, the other operations),
    and the four full products dy h_in, (dt x) R, B R^T and the local
    adjoint (2 q P N each)."""
    products = rest = 0.0
    for s0 in range(0, s, chunk):
        q = min(chunk, s - s0)
        pairs = q * (q + 1) / 2
        products += b * pairs * 2 * n + b * h * (pairs * (4 * p + 4 * n) + 8 * q * p * n)
        rest += 3 * b * h * pairs
    return products, rest


def ssd_scan_bwd_work(b: int, s: int, h: int, p: int, n: int, with_h0: bool,
                      chunk: int = SSD_CHUNK) -> tuple[float, float]:
    """K4's backward: ``ssd_scan_bwd_products``' two summed; x, dt, A, B,
    C, dy and the forward's span states read (and the final state's
    cotangent where it is given, with h0) and dx, ddt, dA, dB, dC (and dh0
    where there is an h0) written."""
    products, rest = ssd_scan_bwd_products(b, s, h, p, n, chunk)
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * h + 4 * b * s * n
                  + b * h * _spans(s, chunk) * p * n + (2 if with_h0 else 0) * b * h * p * n)
    return products + rest, float(nbytes)
