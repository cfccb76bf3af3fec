"""Decentralized-FL core: graphs, schedules, packing, rounds, engines."""
