"""Helpers: ``params`` (parameter init, and the reference's parameter values
into a module)."""
