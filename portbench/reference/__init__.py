"""The benchmark's plain reference (:mod:`.swmhd`): imports nothing of the
program under test."""
