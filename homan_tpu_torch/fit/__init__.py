"""Optimization core: state dataclasses, loss library, stage-C joint fit."""
