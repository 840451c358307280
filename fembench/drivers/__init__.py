"""Solve drivers, one a kind of solve, named by a traffic file's
``driver``.  A driver module has ``Driver`` (set-up, one solve through
the port's public entry point, what a check keeps), ``judge`` (the
numbers that decide ``correct``, from the plain reference) and
``control`` (the reference in the solver's place, in the control's
precision).  It imports the port only inside ``Driver``'s methods, so
``judge`` and ``control`` run without it."""
