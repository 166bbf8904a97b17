"""Exact integer core of Whack-a-Mole: bit reversal, profiles, spraying,
profile updates and the feedback controller."""
