"""Launchers of the port: island-parallel evolution and LM serving."""
