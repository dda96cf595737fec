"""Traffic generators: each reads the parameters of a cell's file
(``portbench/workloads/<cell>.json``) and ``--seed``, and makes the
inputs the program is handed."""
