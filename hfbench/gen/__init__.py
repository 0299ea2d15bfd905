"""Seeded inputs and weights, drawn on the device."""
