"""Roofline of the port's steps: the operation counter (``count``) and
the H100 roofline terms (``analysis``)."""
