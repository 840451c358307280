"""Host seconds of the port's own set-up of the mesh: its tables from the
benchmark's arrays, and the multigrid hierarchy where the solve has one,
each ended by a synchronize."""


def read(run):
    return sum(run.setup.get(k, 0.0) for k in ("port_tables", "hierarchy"))
