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


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that an H100 SM's shared memory holds."""
    return H100_SM_SMEM // (smem + H100_BLOCK_RESERVED)
