"""Plain references the benchmark judges the program's outputs by; they
import nothing of the program."""
