"""Helpers shared by the launchers: the collective-traffic record of a
traced or run step (`collective_stats`)."""
