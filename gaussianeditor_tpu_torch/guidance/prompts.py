"""Prompt-library lookup.

Counterpart of `gaussianeditor_tpu/guidance/prompts.py`'s
`DEFAULT_PROMPT_LIBRARY` and `resolve_prompt`, copied: the editing loop
resolves a "lib:keyword_keyword" prompt through them. The rest of that
module (prompt embeddings, view-dependent prompts) comes with the
guidance slice.
"""

from __future__ import annotations

from typing import Optional

# A small library in the reference's JSON shape ({"dreamfusion": [prompt,
# ...]}); `library_path` loads a user file in the same format.
DEFAULT_PROMPT_LIBRARY = {
    "dreamfusion": [
        "a DSLR photo of a hamburger",
        "a DSLR photo of a panda wearing a chef hat",
        "a marble statue of a lion",
        "a ripe strawberry on a plate",
        "a zoomed out DSLR photo of a wizard raccoon casting a spell",
        "a blue jay standing on a large basket of rainbow macarons",
        "a plush dragon toy",
        "an astronaut riding a horse",
    ]
}


def resolve_prompt(prompt: str, library: Optional[dict] = None,
                   library_path: Optional[str] = None) -> str:
    """A prompt of the form "lib:keyword1_keyword2" resolves to the unique
    library entry containing every keyword (case-insensitive); zero or
    several matches raise ValueError. Other prompts pass through."""
    if not prompt.startswith("lib:"):
        return prompt
    if library is None:
        if library_path is not None:
            import json

            with open(library_path) as f:
                library = json.load(f)
        else:
            library = DEFAULT_PROMPT_LIBRARY
    keywords = prompt[4:].lower().split("_")
    candidate = None
    for entry in library["dreamfusion"]:
        if all(k in entry.lower() for k in keywords):
            if candidate is not None:
                raise ValueError(
                    f"Multiple prompts matched with keywords {keywords} "
                    "in library"
                )
            candidate = entry
    if candidate is None:
        raise ValueError(
            f"Cannot find prompt with keywords {keywords} in library"
        )
    return candidate
