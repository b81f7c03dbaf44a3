"""Launchers of the port's LM stack: the serving steps and the serving loop."""
