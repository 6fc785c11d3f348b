"""The fused decode kernel's lane-steps per decoded word under the genie
early stop: every (lane, loop entry) of its blocks, idle lanes included,
over the words they decoded, from the engagement pair the program keeps on
the card while a profiler runs (`utils.profiling.snapshot()`, under the
early stop's kernel name).  None where the program keeps no such pair."""

from portbench import spans


def read(ctx):
    pair = (spans.table() or {}).get("fused_nms_early_stop")
    if not pair or not pair.get("words"):
        return None
    return pair["lane_steps"] / pair["words"]
