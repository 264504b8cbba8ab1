"""Faults of ``porous_two_fluid`` (config 5): K8 writing nothing, planted
in the program."""


def _k8_writes_nothing(cell):
    """K8 never writes the force planes that ``mc_step`` reads (they keep
    the runner's zeros)."""
    cell.sim._solve_screened = lambda rho, ext, plain: None


FAULTS = {
    "k8_writes_nothing": {"program": _k8_writes_nothing,
                          "fails": ["force_win"]},
}
