"""Time-stepping loops and the solver facade."""
