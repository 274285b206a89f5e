"""Numerical-health diagnostics of the port (``sbr_tpu.diag``): the
`Health` record that rides next to every result, its flag bits, and the
host-side census."""

from sbr_tpu_torch.diag.health import (
    ALL_FLAGS,
    DIVERGENT_MASK,
    FLAG_NAMES,
    Health,
    as_out_crossing,
    flag_names,
    or_reduce_flags,
    summarize,
)

__all__ = [
    "ALL_FLAGS",
    "DIVERGENT_MASK",
    "FLAG_NAMES",
    "Health",
    "as_out_crossing",
    "flag_names",
    "or_reduce_flags",
    "summarize",
]
