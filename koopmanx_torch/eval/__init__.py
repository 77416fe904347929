"""Evaluation: metrics, open-loop validation, Koopman modes, persistence
(counterparts of ``koopmanx/eval/``)."""
