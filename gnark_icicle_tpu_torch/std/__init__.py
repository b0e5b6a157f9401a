"""Gadget standard library (≙ reference std/ — SURVEY.md §2.5): the port
carries the native 2-chain gadgets, copied from gnark_icicle_tpu/std/."""
