"""Deliberate contract violations for tests/test_torch_analysis.py.

Each module here is a minimal counter-example for one auditor rule of the
PyTorch port — run (traced fixtures) or parsed (lint and kernel-source
fixtures) by the analyzer tests, never by production code.  Lines
carrying a violation are tagged with a ``# [viol:<kind>]`` marker (``//
[viol:<kind>]`` in the ``.cu``) so the tests can assert the reported
file:line anchors without hardcoding line numbers.  The ``.cu`` lies here,
not under the kernels' ``csrc/``, whose headers every kernel build hashes.
"""
