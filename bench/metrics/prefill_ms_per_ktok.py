"""prefill_ms_per_ktok: the wall time of the window's admissions
(``ServingEngine.prefill_seconds``: one prompt's prefill, its slot write and
its first token, ended by a device synchronisation) over the prompt tokens
they admitted, in ms per 1000 tokens."""


def read(ctx):
    if not ctx.prefill_seconds or ctx.prompt_tokens_admitted <= 0:
        return None
    return 1e6 * sum(ctx.prefill_seconds) / ctx.prompt_tokens_admitted
