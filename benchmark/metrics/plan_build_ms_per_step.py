"""Host ms per time step spent building the mesh's cached plans and
tables (the program's ``MeshPlans.build_seconds``), over the synchronized
part of a traced window."""


def read(rec):
    if rec["steps"] <= 0:
        return None
    return 1e3 * rec["plan_build_s"] / rec["steps"]
