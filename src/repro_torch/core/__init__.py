"""Tuna core — static analysis optimization of tensor programs, the port's
own copy (plain Python and numpy; no torch, no jax).

Pipeline:  TIR (tir) ──► VISA lowering (visa) ──► Alg.1 joint counting
(instcount) + Alg.2 locality (locality) + ILP scheduling (ilp) ──► linear
cost model (cost_model) ──► ES search (es) over schedule spaces (spaces),
driven by the tuner (tuner).
"""
