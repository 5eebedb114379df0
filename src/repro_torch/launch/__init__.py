"""Launchers: ``train`` (the LM training entry point)."""
