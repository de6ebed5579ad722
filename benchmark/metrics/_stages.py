"""Shared by the stage readers: the device ms per frame of a set of
funky_tpu_torch stage functions in the traced run's profiled eager frame,
each operation counted once, or None where none of them ran."""

from harness.trace import stages_ms


def stage_sum(ctx, stages) -> float | None:
    got = ctx.get("stages")
    if not got:
        return None
    ran, charges = got
    return stages_ms(ran, charges, [f"{m}.{a}" for m, a in stages])
