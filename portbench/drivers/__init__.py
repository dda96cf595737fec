"""Entry paths of the port, one module a path. A driver's ``run(cell,
config, opts)`` sets the program up from the seed, drives the measured
window, reads the traced tail when asked, frees the program, checks what
it produced against the plain reference, and returns a
:class:`portbench.common.Outcome`."""
