"""The launch plan of the one-shot kernel (``ops.oneshot.oneshot_plan``).

The kernel gives each lane a team of T threads of one warp: thread 0 walks
the main chain, the others the candidate chains, several in turn where
there are more chains than threads, in one cooperative launch whose grid
must be resident on the card all at once.  The plan is computed in Python
and handed to the kernel, whose launcher refuses any other.  Here, on the
CPU, over the whole ``oneshot_eligible`` envelope (G <= 4,096 lanes, trees
up to 128 tall, md 2-8, 1-8 table chunks): every chain of a lane lies
on exactly one thread of its team and the main chain on thread 0, teams
do not straddle warps, a block stays within 1,024 threads and its shared
memory within what it may take, and the blocks fit the H100's 132 SMs by
threads, shared memory and the registers ``__launch_bounds__`` allows.
"""

import pytest

from huffmandecoderongpus_tpu_torch.ops import oneshot
from huffmandecoderongpus_tpu_torch.ops.k1_scan2 import _shapes
from huffmandecoderongpus_tpu_torch.ops.k2_compose import NE, groups

GS = (128, 256, 1024, 4096)
HS = (1, 2, 4, 9, 18, 33, 64, 128)
MDS = (2, 3, 6, 8)
#: lane bits of the geometries: the plan's ~500 symbols a lane at 2-16
#: bits a symbol
BS = (256, 2048, 8192)


def _geometry(G, H, md, B):
    """(SEG, steps_p, ORP) as ``widescan._plan`` makes them for lanes of B
    bits: the segment from md, ORP the hard bound (the largest)."""
    unroll = 4 * md
    SEG = unroll * max(1, 32 // unroll)
    steps_p = -(-(B + H) // SEG) * SEG
    ORP = -(-min(B // md + 2, steps_p // md) // 128) * 128
    return SEG, steps_p, ORP


@pytest.mark.parametrize("md", MDS)
@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_plan_teams_hold_every_chain(G, H, md):
    SEG, steps_p, ORP = _geometry(G, H, md, 2048)
    p = oneshot.oneshot_plan(G, H, md, SEG, steps_p, ORP, 1)
    T = p["T"]
    CH = max(H - 1, 1)
    NL = min(md, CH)
    assert T in (4, 8, 16, 32)  # divides a warp: no team straddles one
    assert p["lanes"] * T == p["threads"] == oneshot.THREADS <= 1024
    owners = oneshot.team_chains(T, CH)
    assert owners[0] == []  # thread 0: the main chain alone
    seen = sorted(c for chains in owners for c in chains)
    assert seen == list(range(CH))  # every chain on exactly one thread
    # every leader is the first chain of a thread of its own, so that the
    # leaders walk segment t - 1 side by side
    assert T >= NL + 1
    assert all(owners[c + 1][0] == c for c in range(NL))


@pytest.mark.parametrize("md", MDS)
@pytest.mark.parametrize("H", HS)
@pytest.mark.parametrize("G", GS)
def test_plan_fits_the_card(G, H, md):
    for B in BS:
        for NS in (1, 2, 8):
            _fits(G, H, md, *_geometry(G, H, md, B), NS)


def _fits(G, H, md, SEG, steps_p, ORP, NS):
    p = oneshot.oneshot_plan(G, H, md, SEG, steps_p, ORP, NS)
    CH, HP, cells_p = _shapes(H, steps_p, md)
    NL = min(md, CH)
    lanes = p["lanes"]
    # shared memory: the step table, then every phase's needs, within a
    # block's limit
    assert p["shared"] % 16 == 0
    phases = p["shared"] - oneshot.step_bytes(NS)
    assert phases >= lanes * 4 * oneshot.team_words(CH, NL, SEG // 2)
    assert phases >= groups(G)[1] * NE  # K2's staged group maps
    k4 = p["k4"]
    assert phases >= k4["shared"] + 4 * lanes
    assert k4["vec"] == 4 and lanes % k4["lanes"] == 0
    assert k4["threads"] <= oneshot.THREADS and k4["chunks"] <= 32
    assert p["shared"] <= oneshot.BLOCK_SHARED_MAX
    # co-residency on 132 SMs: threads, shared memory and registers
    per_sm = min(oneshot.SM_THREADS // oneshot.THREADS,
                 oneshot.SM_SHARED // (p["shared"] + oneshot.BLOCK_RESERVED),
                 oneshot.SM_REGISTERS // (oneshot.THREADS * p["registers"]))
    assert p["registers"] == 128  # __launch_bounds__(128, 4)
    assert p["blocks"] == G * p["T"] // oneshot.THREADS
    assert p["blocks"] <= oneshot.SM_COUNT * per_sm
    assert p["fits"]


def test_plan_scratch_cut():
    # the scratch arrays in SCRATCH order, each 256-byte aligned, none
    # overlapping, inside the buffer
    G, H, md = 1024, 9, 2
    SEG, steps_p, ORP = _geometry(G, H, md, 2048)
    p = oneshot.oneshot_plan(G, H, md, SEG, steps_p, ORP, 1)
    CH, HP, cells_p = _shapes(H, steps_p, md)
    L, NGp = groups(G)
    sizes = [cells_p * G * 4, cells_p * G, HP * G * 4, HP * G * 4,
             HP * G * 4, NGp * NE, NGp * 4, NE, G * 4]
    offs = p["offsets"]
    assert len(offs) == len(oneshot.SCRATCH) == len(sizes)
    for i, (o, n) in enumerate(zip(offs, sizes)):
        assert o % 256 == 0
        assert o + n <= (offs[i + 1] if i + 1 < len(offs)
                         else p["scratch_bytes"])
    assert list(p["c_offsets"]) == list(offs)


def test_plan_team_size():
    # the smallest team with a thread a chain, halved to fit the card at
    # G = 4,096, and at least 4
    def T(G, H, md=2):
        SEG, steps_p, ORP = _geometry(G, H, md, 2048)
        return oneshot.oneshot_plan(G, H, md, SEG, steps_p, ORP, 2)["T"]

    assert [T(1024, H) for H in (1, 2, 4, 5, 9, 16, 17, 18, 128)] == [
        4, 4, 4, 8, 16, 16, 32, 32, 32]
    assert T(4096, 128) == T(4096, 18) == 16
    assert T(4096, 9, 8) == 16  # eight leaders need nine threads
    for bad in ((1000, 9, 2, 32, 2080, 1152, 1),  # G % 128
                (1024, 9, 2, 24, 2064, 1152, 1),  # not the plan's SEG
                (1024, 9, 2, 32, 2080, 1152, 9)):  # past 1023 states
        with pytest.raises(ValueError):
            oneshot.oneshot_plan(*bad)
