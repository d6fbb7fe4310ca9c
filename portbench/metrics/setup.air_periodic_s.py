"""Seconds of the AIR build's ``periodic`` region (the chain's four
round-constant interpolants; RescueChainStark.air_profile) in set-up."""

from portbench import program_trace


def read(ctx):
    return (program_trace.air_profile() or {}).get("periodic")
