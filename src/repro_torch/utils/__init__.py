"""Helpers: ``params`` (the reference's parameter values into a module)."""
