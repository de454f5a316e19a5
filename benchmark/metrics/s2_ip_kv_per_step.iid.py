"""The IP branch's ``to_k_ip``/``to_v_ip`` products per stage-2 step: the
program's ``ip.kv_projections`` counter under each stage-2 step of the
window (none where the program does not count them)."""

from benchmark import program_trace as pt

NAME = "s2_ip_kv_per_step.iid"
UNIT = "products"
LAYER = "nn/attention.py IP branch"
MOVES = "image_s"


def kv(r, step):
    return float(r.total(step, "ip.kv_projections"))


def read(rec):
    value = pt.per_step(rec, "omg.generate", "stage2", kv)
    return value or None
