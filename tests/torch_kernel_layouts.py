"""Plain copies of the redesigned kernels' shared-memory layouts, summed as
their sources sum them.  tests/test_torch_kernel_plans.py holds them to a
budget on the CPU, and tests/test_torch_cuda.py holds the libraries' own
counts equal to them on the card.  Imports nothing of torch or JAX."""

#: what an H100 SM holds for blocks (228 KB, less 1 KB the card keeps a block)
H100_SM_SMEM = 228 * 1024
H100_BLOCK_RESERVED = 1024


def pad4(n: int) -> int:
    return -(-n // 4) * 4


def k2_l2_smem(dx: bool, ftp: int, dxw: int, ts: int, gs: int, pc: int, ni: int,
               esize: int) -> int:
    """Bytes of the dense 8-lane K2 forward's (dx False) or dx's block
    (``t2_layout`` in csrc/tp_aggregate.cu): two ring stages, each a tile's
    32 rows of w (FTP channels in the operands' type), their harmonics (13
    floats a row) and the summed entries' operand (forward: four x slices of
    DXW elements in that type; dx: four g rows of FTP channels x 5 lanes,
    f32); then t (32 rows of TS), the coupling entries, the path rows (8
    ints a path), the (path, i) items (5 a path), the live bits of each kept
    entry's summed entries (8 x 32 words), each tile's live rows (256
    words), the list of live tiles and its length (260 ints) and, for dx,
    its per-tile lists; dx's end reuses the ring for 8 x 5 x (FTP | 1)
    sums."""
    stage = pad4(32 * ftp * esize // 4 + 32 * 13 + (4 * ftp * 5 if dx else 4 * dxw * esize // 4))
    floats = (2 * stage + pad4(32 * ts) + pad4(gs) + pad4(pc * 8) + pad4(pc * 5)
              + 8 * 32 + 256 + 260 + (pad4(dxw + 1) + pad4(ni) if dx else 0))
    if dx:
        floats = max(floats, 8 * 5 * (ftp | 1))
    return 4 * floats


def k2_idx_fwd_smem(ftp: int, dxw: int, ts: int, gs: int, pc: int, esize: int) -> int:
    """Bytes of the sender-index K2 forward's block (``t2_layout`` with
    idx): the dense tiled forward's, each stage's x slices one a row (32 of
    DXW elements in the operands' type, not four), then each kept
    receiver's slots' sender rows (8 x 64 ints)."""
    stage = pad4(32 * ftp * esize // 4 + 32 * 13 + 32 * dxw * esize // 4)
    floats = (2 * stage + pad4(32 * ts) + pad4(gs) + pad4(pc * 8) + pad4(pc * 5)
              + 8 * 32 + 256 + 260 + 8 * 64)
    return 4 * floats


def k3_dx_l2_smem(F: int, D: int, ni: int, run: int) -> int:
    """Bytes of the 8-lane K3 dx's block (``x2_floats`` in
    csrc/tp_scalar.cu): the (sender, channel) sums of its run of senders,
    then the d lists (D + 1 extents, NI items)."""
    return 4 * (pad4(run * F) + pad4(D + 1) + pad4(ni))


def edge_l2_smem(dsh: bool, D: int, F: int, pt: int, ps: int, slots: int = 32) -> int:
    """Bytes of the 8-lane edge backward's block (``edge_layout``): the
    receiver's P (PT floats), its senders' x rows (32, or fewer on the
    widest rows: D | 1 floats each), their rows of w, then dw (F | 1
    floats), their harmonics (13 floats) and, with dsh, the paths' sums (PS
    floats)."""
    return 4 * (pad4(pt) + slots * (D | 1) + slots * (F | 1) + slots * 13 + (ps if dsh else 0))


def idx_dx_l2_smem(D: int, F: int, n_paths: int, ts: int, gs: int, ni: int, esize: int,
                   lanes: int) -> int:
    """Bytes of the sender-index dx's chunk block (``xi_layout``): two ring
    stages, each 4 slots' rows of w (F elements of the operands' type at a
    16-byte pitch), harmonics (13 floats) and receivers' g rows (F float4s,
    at 8 lanes F floats more); t of 4 slots (TS floats each), the coupling
    entries (GS), the (path, i) items (5 a path), the live slots and their
    count (36 ints); then, past the (component, channel) sums (5 F floats)
    that the end writes over what comes before, the d lists (D + 1 extents,
    NI items)."""
    per = 16 // esize
    stage = pad4(4 * (-(-F // per) * per) * esize // 4 + pad4(4 * 13) + 4 * F * 4
                 + (4 * F if lanes == 8 else 0))
    floats = 2 * stage + pad4(4 * ts) + pad4(gs) + pad4(n_paths * 5) + 36
    return 4 * (max(floats, pad4(5 * F)) + pad4(D + 1) + pad4(ni))


def k3_fwd_l2_smem(R: int, SL: int, F: int, MC: int, S: int, D: int) -> int:
    """Bytes of the dense 8-lane K3 forward's block (``f2_floats`` in
    csrc/tp_scalar.cu): while it sums, MC senders' harmonics for each of R
    receivers (R MC S floats, padded to four) and their rows of x (MC D); at
    the end, over the same space, the five sums of each (receiver, slice,
    channel); the larger of the two."""
    return 4 * max(R * SL * F * 5, pad4(R * MC * S) + MC * D)


def k3_edge_l2_smem(dsh: bool, S: int, n_items: int) -> int:
    """Bytes of the dense 8-lane K3 edge backward's block (at most 32 units
    an edge): with dsh, each of its 256 lanes' five sums, then the component
    lists (S + 1 extents, n_items entries); without, a one-float
    placeholder."""
    return 4 * (256 * 5 + S + 1 + n_items) if dsh else 4


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that an H100 SM's shared memory holds."""
    return H100_SM_SMEM // (smem + H100_BLOCK_RESERVED)
