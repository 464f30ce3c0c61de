"""SiddhiQL compiler: text -> query_api AST.

Replacement for the reference's ANTLR4 pipeline
(``modules/siddhi-query-compiler``, grammar ``SiddhiQL.g4``): a hand-rolled
tokenizer + recursive-descent parser covering the same rule set, entry
points mirroring ``SiddhiCompiler`` (SiddhiCompiler.java:63,:193,:233).
"""

from siddhi_tpu_torch.compiler.compiler import SiddhiCompiler, SiddhiParserError
