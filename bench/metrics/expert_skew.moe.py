"""expert_skew.moe: the rows at the busiest expert of each routed call
over the mean rows an expert, over the traced slice: the program's
``moe.busiest_rows`` over ``moe.rows{kind=routed}`` / E (counters).  1
is an even spread; B1's grouped launch waits for its busiest expert."""

from benchlib import program


def read(rec):
    c = program.counters(rec)
    if not c:
        return None
    busiest = c.get("moe.busiest_rows")
    routed = c.get("moe.rows{kind=routed}")
    if busiest is None or not routed:
        return None
    return busiest * rec.cfg["n_routed_experts"] / routed
