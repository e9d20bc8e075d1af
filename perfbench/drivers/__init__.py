"""The general generators: each drives one entry point of the program with
the parameters of a traffic mix (`perfbench/traffic/<mix>.json` names its
driver) and checks what it answered against the plain reference."""
