"""Launchers of the port: one engine on one card, served (`serve`) or
traced (`obs`)."""
