"""Launchers: the serving and training command lines."""
