"""Token slots the program hands to MR² over the window of the TPC-DS cell
over the tokens MR² needs for the same queries, as a ratio: the reader of
``fct_count_launch_padding.chain`` (the sum of each answer's
``engine_stats['fct_count_tokens']`` over the reference's
``weighted_tokens``, each weighted row at its own relation's width).  The
fact, STORE_SALES, has width 0, so it needs no token: a program that hands
MR² its padded PAD ids reads higher.  None where the answers carry no
such count or the reference gives no ``weighted_tokens``."""
from bench.harness import reader

read = reader("fct_count_launch_padding.chain")
