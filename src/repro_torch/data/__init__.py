"""Seeded synthetic KRR datasets."""
