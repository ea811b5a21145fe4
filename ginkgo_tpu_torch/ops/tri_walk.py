"""The route and launch of K22, K23 and K24 (``csrc/trs_fused.cu``'s plans).

A sweep solve x ~ T^{-1} rhs (x0 = invd * rhs, then ``sweeps`` times
x <- invd * (rhs - N x), N a strict triangle) can run as one walk over a
block's rows (``csrc/tri_walk.cuh``) when the triangle's offsets are all of
one sign: increasing rows for a lower triangle, decreasing for an upper
one.  The kernel library derives the walk from the offsets and the sweep
count, and chooses the route from that shape alone: a triangle whose
offsets change sign, or whose rings do not fit a block's shared memory,
takes the barrier routine (``gk_tri_sweeps``).  :func:`plan` asks it once
per shape.
"""

from __future__ import annotations

import ctypes

import torch

from .dia import check_status, offsets_array

#: a plan's figures, in the order csrc/trs_fused.cu writes them
PLAN_FIELDS = ("route", "blocks", "threads", "chunk", "smem", "blocks_per_sm", "registers",
               "grid_barriers", "unrolled")
#: each walk's figures after them: its direction (+1 forward for a lower
#: triangle, -1 backward for an upper one), w = max |offset|, the rows of a
#: level ring, the chunks of the input ring and the interior steps of all
#: blocks (the steps that run every level unrolled where "unrolled")
WALK_FIELDS = ("direction", "width", "ring_rows", "stages", "interior_steps")
#: the route codes: K24's third walks with p formed in a pass of its own
ROUTES = ("barrier", "pipelined", "pipelined_p_pass")

#: (plan function, its arguments, device index) -> the plan
_PLANS: dict = {}


def plan(lib, fn: str, args: tuple, walks: int, device) -> dict:
    """The route and launch that the plan function ``fn`` of
    ``csrc/trs_fused.cu`` chooses (``PLAN_FIELDS``, "route" by name, and
    under "walks" each of the solve's ``walks`` walks' ``WALK_FIELDS``, or
    none on the barrier route), asked once per (function, arguments,
    device).  ``args``: ints, and tuples of offsets, which travel as int64
    arrays."""
    key = (fn, args, device.index)
    if key not in _PLANS:
        out = (ctypes.c_longlong * (len(PLAN_FIELDS) + walks * len(WALK_FIELDS)))()
        c_args = [offsets_array(a) if isinstance(a, tuple) else a for a in args]
        with torch.cuda.device(device):
            status = getattr(lib, fn)(*c_args, out)
        check_status(lib, status, fn)
        head = dict(zip(PLAN_FIELDS, out))
        head["route"] = ROUTES[head["route"]]
        head["unrolled"] = bool(head["unrolled"])
        w = len(WALK_FIELDS)
        head["walks"] = ([dict(zip(WALK_FIELDS, out[len(PLAN_FIELDS) + i * w:][:w]))
                          for i in range(walks)] if head["route"] != "barrier" else [])
        _PLANS[key] = head
    return _PLANS[key]


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (the
    walk stages vectors 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
