"""Trainer CLIs."""
