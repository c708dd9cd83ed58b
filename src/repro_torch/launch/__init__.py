"""Launchers: command-line entry points."""
